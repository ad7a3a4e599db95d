"""Port twins of the chr1-lite tests of tests/test_chr1_scale.py and of
tests/test_thread_determinism.py.

The workload is the port's utils/bench_workload.build_cleaner_workload(
n_scenarios=200, n_bulk=3000), about 33 Mb, built once per session in a
directory of this file's own (never the reference's /tmp/gat_lite, on which
two test workers would race).  chainCleaner and chainNet -rescore through
the port's CLI (-device=cpu) must give the C binaries' hashes of
tests/golden/chr1_lite.json in window mode and in pair mode (int8 tiles,
GAT_RESCORE=pair GAT_COMBINE=device), scoring through the port.  The thread
twins run the port's CLI in subprocesses at GAT_THREADS=1 and =8: the port
builds its own native library, whose threaded paths must give the same bytes
at any thread count (RepeatFiller's twin is
tests/test_torch_goldens_repeatfiller_threads.py).

Not twinned: test_chaincleaner_chr1_scale_byte_parity, which needs the C
reference build (.ref_build) and GAT_BIG_TESTS=1.

test_engine_outputs_equal_the_reference_engines calls the port's engines
directly (-device=cpu, window mode) on small workloads of the same builders
and holds them byte for byte to the reference engines on the same files:
chainCleaner and chainNet -rescore -linearGap=loose on
build_cleaner_workload(20, 200), scoreChain on build_workload at 2 Mb and 8
chains, and the 6 gaps of build_repeatfiller_workload(n_gaps=6) through the
port's gap jobs (its band batch and the host one, GAT_BAND=host) against the
reference's host band batch, by an md5 of each filled gap's first mini-chain.
"""

import hashlib
import importlib

import pytest

import golden_cases as gc
from genomealignmenttools_tpu_torch.cli.main import main as port_main
from genomealignmenttools_tpu_torch.device import PERF, perf_reset


@pytest.fixture(scope="session")
def lite_workload(tmp_path_factory):
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_cleaner_workload
    return build_cleaner_workload(str(tmp_path_factory.mktemp("lite")),
                                  n_scenarios=gc.LITE_SCENARIOS,
                                  n_bulk=gc.LITE_BULK)


@pytest.mark.parametrize("mode", ["window", "pair"])
@pytest.mark.parametrize("case", sorted(gc.lite_cases({k: "" for k in (
    "chain", "t2bit", "q2bit", "t_sizes", "q_sizes")}, "")))
def test_chr1_lite_matches_c_hashes(lite_workload, tmp_path, monkeypatch,
                                    case, mode):
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    gc.set_mode(monkeypatch, mode)
    argv, outputs = gc.lite_cases(lite_workload, str(tmp_path))[case]
    set_verbosity(0)
    perf_reset()
    assert port_main(argv + ["-device=cpu"]) == 0
    assert PERF["dispatches"] > 0
    hashes = gc.lite_hashes()
    for path, key in outputs:
        assert gc.sha256(path) == hashes[key], key


def outputs_at_1_and_8_threads(args_at, tmp_path):
    from conftest import hermetic_cpu_env
    return gc.port_cli_at_1_and_8_threads(args_at, tmp_path,
                                          hermetic_cpu_env())


def test_chaincleaner_thread_determinism(lite_workload, tmp_path):
    m = lite_workload
    outs = outputs_at_1_and_8_threads(lambda d: (
        ["chainCleaner", m["chain"], m["t2bit"], m["q2bit"],
         str(d / "out.chain"), str(d / "out.bed"), "-tSizes=" + m["t_sizes"],
         "-qSizes=" + m["q_sizes"], "-linearGap=loose"],
        ["out.chain", "out.bed"]), tmp_path)
    assert outs[1] == outs[8]
    assert gc.sha256(str(tmp_path / "t1" / "out.chain")) == \
        gc.lite_hashes()["c_out.chain.sha256"]


def test_chainnet_rescore_thread_determinism(lite_workload, tmp_path):
    m = lite_workload
    outs = outputs_at_1_and_8_threads(lambda d: (
        ["chainNet", "-rescore", "-linearGap=loose", "-tNibDir=" + m["t2bit"],
         "-qNibDir=" + m["q2bit"], m["chain"], m["t_sizes"], m["q_sizes"],
         str(d / "t.net"), str(d / "q.net")], ["t.net", "q.net"]), tmp_path)
    assert outs[1] == outs[8]


def test_scorechain_thread_determinism(lite_workload, tmp_path):
    m = lite_workload
    outs = outputs_at_1_and_8_threads(lambda d: (
        ["scoreChain", m["chain"], m["t2bit"], m["q2bit"],
         str(d / "out.chain"), "-linearGap=loose"], ["out.chain"]), tmp_path)
    assert outs[1] == outs[8]


def test_chaincleaner_prescore_and_net_phases_nest(lite_workload, tmp_path):
    """chainCleaner (window mode, the python break loop) on chr1-lite under
    a phase accumulation: `cleaner: prescore` lies inside `break_loop`,
    `cleaner: net` inside `net+find_breaks`, each phase inside the root
    `chainCleaner`; the output keeps the C binaries' hash."""
    from benchmark.lib import spans
    from genomealignmenttools_tpu_torch.engines.chain_cleaner import \
        clean_chains
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    m = lite_workload
    out = str(tmp_path / "out.chain")
    set_verbosity(0)
    rec = spans.start()
    try:
        clean_chains(m["chain"], m["t2bit"], m["q2bit"], out,
                     str(tmp_path / "out.bed"), t_sizes=m["t_sizes"],
                     q_sizes=m["q_sizes"], linear_gap="loose", device="cpu")
    finally:
        spans.stop(rec)
    by_name = {}
    for name, a, b in rec.intervals:
        by_name.setdefault(name, []).append((a, b))
    slack = 1e-3                # the recorder notes an end after the fact

    def inside(inner, outer):
        (lo, hi), = by_name[outer]
        return by_name[inner] and all(lo - slack <= a and b <= hi + slack
                                      for a, b in by_name[inner])

    assert inside("cleaner: prescore", "break_loop")
    assert inside("cleaner: net", "net+find_breaks")
    assert all(inside(name, "chainCleaner") for name in by_name)
    assert gc.sha256(out) == gc.lite_hashes()["c_out.chain.sha256"]


RF_GAPS = 6


@pytest.fixture(scope="module")
def small_workloads(tmp_path_factory):
    """The chainCleaner and chr1 workloads at small sizes, and the
    RepeatFiller workload at just the gaps the test runs."""
    from genomealignmenttools_tpu_torch.utils.bench_workload import (
        build_cleaner_workload, build_repeatfiller_workload, build_workload)
    d = tmp_path_factory.mktemp("small")
    return {
        "cleaner": build_cleaner_workload(str(d / "cleaner"), n_scenarios=20,
                                          n_bulk=200),
        "chr1": build_workload(str(d / "chr1"), t_size=2_000_000,
                               n_chains=8),
        "repeatfiller": build_repeatfiller_workload(str(d / "rf"),
                                                    n_gaps=RF_GAPS)}


def _gap_checksum(pkg, m, device=None):
    """md5 over the first mini-chain of every filled gap of the workload's
    first RF_GAPS gap jobs, through `pkg`'s gap jobs and GapAligner (the
    band batch GAT_BAND picks); (digest, gaps filled)."""
    genome = importlib.import_module(pkg + ".device.genome")
    rf = importlib.import_module(pkg + ".engines.repeat_filler")
    gapcalc = importlib.import_module(pkg + ".formats.gapcalc")
    scorematrix = importlib.import_module(pkg + ".formats.scorematrix")
    seed_extend = importlib.import_module(pkg + ".ops.seed_extend")
    with open(m["chain"]) as f:
        lines = [ln + "\n" for ln in f.read().split("\n")]
    jobs = rf.harvest_gap_jobs(lines, 0, 0, 0, 10, 10, 100000,
                               100000)[:RF_GAPS]
    assert len(jobs) == RF_GAPS
    scheme = scorematrix.score_scheme_default()
    kw = {} if device is None else {"device": device}
    aligner = seed_extend.GapAligner(
        scheme.lut, seed_len=6, hsp_threshold=1500, gapped_threshold=2000,
        gap_open=scheme.gap_open, gap_extend=scheme.gap_extend,
        char_matrix=scheme.char_matrix(), **kw)
    h, filled = hashlib.md5(), 0
    for _job, minis in rf._run_gap_jobs(
            jobs, genome.open_genome(m["t2bit"]),
            genome.open_genome(m["q2bit"]), aligner, scheme,
            gapcalc.gap_calc_from_file("loose")):
        if minis:
            filled += 1
            h.update(minis[0].to_text().encode())
    return h.hexdigest(), filled


def _run_cleaner(pkg, m, out, **kw):
    engine = importlib.import_module(pkg + ".engines.chain_cleaner")
    engine.clean_chains(m["chain"], m["t2bit"], m["q2bit"], out + ".chain",
                        out + ".bed", t_sizes=m["t_sizes"],
                        q_sizes=m["q_sizes"], linear_gap="loose", **kw)
    return [out + ".chain", out + ".bed"]


def _run_chainnet(pkg, m, out, **kw):
    engine = importlib.import_module(pkg + ".engines.chain_net")
    with open(out + ".t.net", "w") as t_out, open(out + ".q.net", "w") as q:
        engine.chain_net(m["chain"], m["t_sizes"], m["q_sizes"], t_out, q,
                         rescore=True, t_2bit=m["t2bit"], q_2bit=m["q2bit"],
                         linear_gap="loose", **kw)
    return [out + ".t.net", out + ".q.net"]


def _run_scorechain(pkg, m, out, **kw):
    engine = importlib.import_module(pkg + ".engines.score_chain")
    engine.score_chain_file(m["chain"], m["t2bit"], m["q2bit"],
                            out + ".chain", linear_gap="loose", **kw)
    return [out + ".chain"]


ENGINES = {"cleaner": ("cleaner", _run_cleaner),
           "chainnet_rescore": ("cleaner", _run_chainnet),
           "scorechain": ("chr1", _run_scorechain)}
PORT, REF = "genomealignmenttools_tpu_torch", "genomealignmenttools_tpu"


@pytest.mark.parametrize("engine", ["cleaner", "chainnet_rescore",
                                    "scorechain", "repeatfiller"])
def test_engine_outputs_equal_the_reference_engines(small_workloads, engine,
                                                    tmp_path, monkeypatch):
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    gc.set_mode(monkeypatch, "window")
    set_verbosity(0)
    if engine == "repeatfiller":
        m = small_workloads["repeatfiller"]
        monkeypatch.delenv("GAT_BAND", raising=False)
        device = _gap_checksum(PORT, m, device="cpu")
        monkeypatch.setenv("GAT_BAND", "host")
        host = _gap_checksum(PORT, m, device="cpu")
        want = _gap_checksum(REF, m)
        assert device == host == want
        assert want[1] > 0
        return
    workload, run = ENGINES[engine]
    m = small_workloads[workload]
    got = run(PORT, m, str(tmp_path / "port"), device="cpu")
    want = run(REF, m, str(tmp_path / "ref"))
    for g, w in zip(got, want, strict=True):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            got_bytes, want_bytes = fg.read(), fw.read()
        assert got_bytes and got_bytes == want_bytes, (g, w)
