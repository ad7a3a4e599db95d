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
"""

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
