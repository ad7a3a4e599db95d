"""The port's bench (genomealignmenttools_tpu_torch/bench.py) on the CPU.

The bench runs once in a subprocess with --device=cpu at small sizes
(chainCleaner 20 scenarios + 200 bulk chains, chr1 2 Mb and 8 chains, the
first 6 gaps of the RepeatFiller workload): its last line is one JSON
object with the root bench.py's top-level keys (read from its RESULT by
parsing, not by running it), every parity field is true, it loaded neither
jax nor the JAX package, and its outputs equal the reference engines' on
the same workload files, exactly (everything is integer).  A budget small
enough for the watchdog to fire still gives one line and exit code 0.
"""

import ast
import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import hermetic_cpu_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ["--device=cpu", "--cleaner-scenarios", "20", "--cleaner-bulk", "200",
         "--chr1-size", "2000000", "--chr1-chains", "8", "--rf-gaps", "6"]
SECTIONS = ["workload_cleaner", "cleaner", "chainnet_rescore", "workload_chr1",
            "scorechain", "resident", "workload_repeatfiller", "repeatfiller",
            "cleaner_1thread"]

# runs the bench as `python -m` would, then reports what was loaded
_WRAP = r"""
import runpy, sys
sys.argv = ["bench"] + sys.argv[1:]
try:
    runpy.run_module("genomealignmenttools_tpu_torch.bench",
                     run_name="__main__")
finally:
    print("LOADED", sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith(("jax.", "jaxlib"))
        or m == "genomealignmenttools_tpu"
        or m.startswith("genomealignmenttools_tpu.")), file=sys.stderr)
"""


def run_bench(work_dir: str, budget: str = "390"):
    env = hermetic_cpu_env()
    env.update(GAT_BENCH_DIR=work_dir, GAT_BENCH_BUDGET_S=budget,
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", _WRAP, *SIZES], env=env,
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    lines = p.stdout.strip().splitlines()
    assert lines, f"no output; rc {p.returncode}; stderr {p.stderr[-3000:]}"
    return p, json.loads(lines[-1])


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("bench"))
    p, result = run_bench(work)
    return p, result, work


def reference_keys() -> list[str]:
    """The keys of the root bench.py's RESULT literal."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "RESULT"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no RESULT literal")


def test_bench_prints_one_line_with_the_reference_keys(bench):
    p, result, _ = bench
    assert p.returncode == 0, p.stderr[-3000:]
    keys = reference_keys()
    assert keys == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert list(result) == keys
    assert result["metric"] == "chaincleaner_chr1_wallclock"
    assert result["value"] == \
        result["extra"]["cleaner"]["port_window"]["warm_s"]["median"]
    assert sum(ln.startswith("{") for ln in p.stdout.splitlines()) == 1
    extra = result["extra"]
    assert extra["sections_done"] == SECTIONS
    assert extra["failures"] == []
    assert extra["completed"] == "all"
    assert extra["device"]["type"] == "cpu"
    assert extra["sizes"] == {
        "cleaner_n_scenarios": 20, "cleaner_n_bulk": 200,
        "chr1_t_size": 2_000_000, "chr1_n_chains": 8,
        "repeatfiller_n_gaps": 6, "repeatfiller_workload_gaps": 3000}
    for mode in ("port_window", "port_pair", "hostnative"):
        warm = extra["cleaner"][mode]["warm_s"]
        assert len(warm["runs"]) >= 3
        assert warm["min"] <= warm["median"] <= warm["max"]
    assert len(extra["cleaner"]["warm_1thread_s"]["runs"]) >= 3


def test_bench_every_parity_field_is_true(bench):
    _, result, _ = bench
    extra = result["extra"]
    for section in ("cleaner", "chainnet_rescore", "scorechain"):
        parity = extra[section]["byte_identical"]
        assert parity and all(parity.values()), (section, parity)
    assert set(extra["cleaner"]["byte_identical"]) == {
        "window_vs_hostnative", "pair_vs_hostnative", "1thread_vs_hostnative"}
    assert extra["resident"]["matches_hostnative"] is True
    assert extra["repeatfiller"]["device_matches_host"] is True
    # on the CPU no wrapper launches a kernel, and no device number is given
    assert extra["resident"]["pct_of_h100_hbm_3_35_tbs"] is None
    assert extra["resident"]["link"] is None


def test_bench_loads_neither_jax_nor_the_jax_package(bench):
    p, _, _ = bench
    assert "LOADED []" in p.stderr, p.stderr[-3000:]


def test_bench_watchdog_still_prints_one_line(tmp_path):
    p, result = run_bench(str(tmp_path), budget="13.5")
    assert p.returncode == 0, p.stderr[-3000:]
    assert sum(ln.startswith("{") for ln in p.stdout.splitlines()) == 1
    assert list(result) == reference_keys()
    assert result["extra"]["completed"] == "watchdog(budget exhausted)"
    assert "cleaner_1thread" not in result["extra"]["sections_done"]


def _reference_cleaner(m, out):
    from genomealignmenttools_tpu.engines.chain_cleaner import clean_chains
    clean_chains(m["chain"], m["t2bit"], m["q2bit"], out + ".chain",
                 out + ".bed", t_sizes=m["t_sizes"], q_sizes=m["q_sizes"],
                 linear_gap="loose")
    return [out + ".chain", out + ".bed"]


def _reference_chainnet(m, out):
    from genomealignmenttools_tpu.engines.chain_net import chain_net
    with open(out + ".t.net", "w") as t_out, open(out + ".q.net", "w") as q:
        chain_net(m["chain"], m["t_sizes"], m["q_sizes"], t_out, q,
                  rescore=True, t_2bit=m["t2bit"], q_2bit=m["q2bit"],
                  linear_gap="loose")
    return [out + ".t.net", out + ".q.net"]


def _reference_scorechain(m, out):
    from genomealignmenttools_tpu.engines.score_chain import score_chain_file
    score_chain_file(m["chain"], m["t2bit"], m["q2bit"], out + ".chain",
                     linear_gap="loose")
    return [out + ".chain"]


def _reference_checksum(m, n_gaps, monkeypatch):
    from genomealignmenttools_tpu.device.genome import open_genome
    from genomealignmenttools_tpu.engines.repeat_filler import (
        _run_gap_jobs, harvest_gap_jobs)
    from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu.ops.seed_extend import GapAligner
    monkeypatch.setenv("GAT_BAND", "host")
    with open(m["chain"]) as f:
        lines = [ln + "\n" for ln in f.read().split("\n")]
    jobs = harvest_gap_jobs(lines, 0, 0, 0, 10, 10, 100000, 100000)[:n_gaps]
    scheme = score_scheme_default()
    aligner = GapAligner(scheme.lut, seed_len=6, hsp_threshold=1500,
                         gapped_threshold=2000, gap_open=scheme.gap_open,
                         gap_extend=scheme.gap_extend,
                         char_matrix=scheme.char_matrix())
    h = hashlib.md5()
    for _job, minis in _run_gap_jobs(jobs, open_genome(m["t2bit"]),
                                     open_genome(m["q2bit"]), aligner,
                                     scheme, gap_calc_from_file("loose")):
        if minis:
            h.update(minis[0].to_text().encode())
    return h.hexdigest()


def _files(work: str, section: str):
    """The workload and the bench's default-mode outputs of a section."""
    if section in ("cleaner", "chainnet_rescore"):
        d = os.path.join(work, "cleaner_20_200")
        m = {"chain": "cleaner.chain", "t2bit": "ct.2bit", "q2bit": "cq.2bit",
             "t_sizes": "ct.sizes", "q_sizes": "cq.sizes"}
    elif section == "scorechain":
        d = os.path.join(work, "chr1_2000000_8")
        m = {"chain": "bench.chain", "t2bit": "t.2bit", "q2bit": "q.2bit"}
    else:
        d = os.path.join(work, "repeatfiller_3000")
        m = {"chain": "rf.chain", "t2bit": "rt.2bit", "q2bit": "rq.2bit"}
    return {k: os.path.join(d, v) for k, v in m.items()}


@pytest.mark.parametrize("section", ["cleaner", "chainnet_rescore",
                                     "scorechain", "repeatfiller"])
def test_bench_outputs_equal_the_reference_engines(bench, section, tmp_path,
                                                   monkeypatch):
    _, result, work = bench
    extra = result["extra"]
    m = _files(work, section)
    if section == "repeatfiller":
        rf = extra["repeatfiller"]
        want = _reference_checksum(m, 6, monkeypatch)
        assert rf["device"]["checksum"] == rf["host"]["checksum"] == want
        assert rf["n_gaps"] == 6 and rf["device"]["filled"] > 0
        return
    make = {"cleaner": _reference_cleaner,
            "chainnet_rescore": _reference_chainnet,
            "scorechain": _reference_scorechain}[section]
    want = make(m, str(tmp_path / "ref"))
    got = list(extra[section]["outputs"].values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            got_bytes, want_bytes = fg.read(), fw.read()
        assert got_bytes and got_bytes == want_bytes, (g, w)
