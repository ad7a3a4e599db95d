"""The port's profiler: -profile=dir on the port CLI, trace and the phase
spans.

On the CPU the trace holds CPU activity only; the scoreChain output under
the profiler must stay byte-identical to the golden.  The phases: each is a
record_function range while torch.profiler records (and only then), a
phase on a helper thread leaves the accumulation alone, and a RepeatFiller
call is its stages one after another, each over a whole chunk of gaps.
"""

import functools
import io
import json
import os
import threading

import pytest
import torch

from genomealignmenttools_tpu_torch.cli.main import main as port_main
from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.utils import profiling
from benchmark.lib import spans


def recorded(fn):
    """fn() under the benchmark's phase recorder, which notes the
    intervals the harness reads; returns (fn's result, the recorder)."""
    rec = spans.start()
    try:
        return fn(), rec
    finally:
        spans.stop(rec)


@pytest.fixture
def no_profile_dir(monkeypatch):
    """The profile directory is process-wide: leave it unset after the
    test, whatever the CLI set."""
    monkeypatch.delenv("GAT_PROFILE", raising=False)
    yield
    profiling.set_profile_dir(None)


def test_profile_flag_writes_trace_and_keeps_output(fixtures_dir, golden_dir,
                                                    tmp_path, no_profile_dir):
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    out, prof = str(tmp_path / "s.chain"), str(tmp_path / "prof")
    perf_reset()
    assert port_main(["scoreChain", f("synthetic.chain"), f("target.2bit"),
                      f("query.2bit"), out, "-linearGap=loose",
                      "-profile=" + prof, "-device=cpu"]) == 0
    assert PERF["dispatches"] > 0
    with open(out, "rb") as a, open(os.path.join(
            golden_dir, "scoreChain.loose.chain"), "rb") as b:
        assert a.read() == b.read()
    assert profiling.profile_dir() == prof
    (name,) = os.listdir(prof)
    with open(os.path.join(prof, name)) as fh:
        events = json.load(fh)["traceEvents"]
    # the plain chunk sums ran inside the traced window
    assert any(e.get("name") == "aten::index_add_" for e in events)


def test_trace_is_a_noop_without_a_directory(tmp_path, no_profile_dir):
    with profiling.trace(device="cpu"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert os.listdir(tmp_path) == []
    with profiling.trace(str(tmp_path / "t"), device="cpu"):
        torch.ones(3).sum()
    assert len(os.listdir(tmp_path / "t")) == 1


def test_phase_is_a_range_only_while_the_profiler_records(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.phase("idle profiler"):
        torch.ones(3).sum()
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.phase("outer"):
            with profiling.phase("inner"):
                torch.ones(3).sum()
    assert made == ["outer", "inner"]


def test_phase_on_another_thread_leaves_the_accumulation_alone(
        monkeypatch):
    from genomealignmenttools_tpu_torch.utils import verbose
    log = io.StringIO()
    monkeypatch.setattr(verbose, "_log_file", log)
    monkeypatch.setattr(verbose, "_level", 2)

    def helper():
        with profiling.phase("helper"):
            pass

    def both():
        with profiling.phase("main"):
            t = threading.Thread(target=helper)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()

    _, rec = recorded(both)
    assert rec.keys() == {"main"}
    assert [n for n, _, _ in rec.intervals] == ["main"]
    # the helper's phase still logs
    assert "helper: " in log.getvalue() and "main: " in log.getvalue()


def test_phase_formats_no_line_below_its_verbosity(monkeypatch):
    from genomealignmenttools_tpu_torch.utils import verbose
    said = []
    monkeypatch.setattr(profiling, "verbose",
                        lambda level, msg: said.append(msg))
    monkeypatch.setattr(verbose, "_level", 1)
    with profiling.phase("quiet"):
        pass
    assert said == []
    monkeypatch.setattr(verbose, "_level", 2)
    with profiling.phase("loud"):
        pass
    assert len(said) == 1 and said[0].startswith("loud: ")


# --- RepeatFiller's stages ----------------------------------------------

RF_STAGES = ["rf: seed", "rf: hsp scan", "rf: band problems",
             "band: host batch", "rf: gapped finish", "rf: chain"]


@pytest.fixture(scope="module")
def rf24(tmp_path_factory):
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_repeatfiller_workload
    return build_repeatfiller_workload(str(tmp_path_factory.mktemp("rf24")),
                                       n_gaps=24)


def _rf(m, **kw):
    from genomealignmenttools_tpu_torch.engines import repeat_filler as rf
    out = io.StringIO()
    rf.repeat_filler(m["chain"], m["t2bit"], m["q2bit"], out, device="cpu",
                     **kw)
    return out.getvalue()


@pytest.mark.parametrize("chunk", [4096, 10])
def test_repeatfiller_phases_are_its_stages_once_a_chunk(rf24, chunk,
                                                         monkeypatch):
    """Every stage runs over a whole chunk of gaps before the next, as one
    phase; the stages follow each other inside the root phase and cover
    it.  The band DP runs as the host band batch (GAT_BAND=host), which
    gives the same bytes as K3 and its plain version, fast on the CPU."""
    from genomealignmenttools_tpu_torch.engines import repeat_filler as rf
    monkeypatch.setenv("GAT_BAND", "host")
    monkeypatch.setattr(rf, "_run_gap_jobs",
                        functools.partial(rf._run_gap_jobs, chunk=chunk))
    out, rec = recorded(lambda: _rf(rf24))
    (root,) = [(a, b) for n, a, b in rec.intervals if n == "repeatfiller"]
    staged = [(n, a, b) for n, a, b in rec.intervals
              if n.startswith(("rf: ", "band: "))]
    n_chunks = -(-24 // chunk)
    assert [n for n, _, _ in staged] == (["rf: read + harvest"]
                                         + RF_STAGES * n_chunks
                                         + ["rf: splice + write"])
    for (_, _, b0), (_, a1, _) in zip(staged, staged[1:]):
        assert b0 <= a1                             # one after another
    slack = 1e-3                # the recorder notes an end after the fact
    assert all(root[0] - slack <= a and b <= root[1] + slack
               for _, a, b in staged)
    covered = sum(b - a for _, a, b in staged)
    assert covered >= 0.9 * (root[1] - root[0])
    assert out.count("chain ") >= 1


def test_repeatfiller_phases_one_set_a_gap_and_the_same_bytes(
        rf24, fixtures_dir, golden_dir, monkeypatch):
    """GAT_RF_BATCH=0 runs the same stages one gap at a time, and gives
    the batched path's bytes; the quirks run keeps the golden's bytes
    under an accumulation."""
    monkeypatch.setenv("GAT_BAND", "host")
    batched = _rf(rf24)
    monkeypatch.setenv("GAT_RF_BATCH", "0")
    sequential, rec = recorded(lambda: _rf(rf24))
    assert sequential == batched
    names = [n for n, _, _ in rec.intervals]
    assert all(names.count(stage) == 24 for stage in RF_STAGES)
    monkeypatch.delenv("GAT_RF_BATCH")
    monkeypatch.delenv("GAT_BAND")
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    quirks, rec = recorded(lambda: _rf(
        {"chain": f("repeatfiller_input.chain"), "t2bit": f("target.2bit"),
         "q2bit": f("query.2bit")}, ref_quirks=True))
    with open(os.path.join(golden_dir,
                           "repeatfiller_reference_output.chain")) as g:
        assert quirks == g.read()
    assert {"repeatfiller", "rf: seed", "band: DP + fetch",
            "rf: chain"} <= rec.keys()


def test_repeatfiller_phases_are_user_annotations_in_the_trace(
        fixtures_dir, tmp_path):
    """Under a CPU torch.profiler.profile every phase of a RepeatFiller
    call (K3's plain version on the fixture's gaps) is a range of the same
    name in the Chrome trace."""
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    m = {"chain": f("repeatfiller_input.chain"), "t2bit": f("target.2bit"),
         "q2bit": f("query.2bit")}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, rec = recorded(lambda: _rf(m))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    assert {"repeatfiller", "rf: read + harvest", "rf: seed",
            "band: DP + fetch", "rf: splice + write"} <= rec.keys()
    assert rec.keys() <= ranges


# --- chainNet's phases and counters -------------------------------------

CHAINNET = ["chainnet: parse", "chainnet: net sweep",
            "chainnet: rescore fills", "chainnet: write"]


@pytest.fixture(scope="module")
def pair12(tmp_path_factory):
    from benchmark.workloads import cleaner
    return cleaner.generate(2 ** 32 + 5, {"n_scenarios": 12, "n_bulk": 60},
                            str(tmp_path_factory.mktemp("pair12")))


def _chain_net(w, min_space, **kw):
    from genomealignmenttools_tpu_torch.engines.chain_net import chain_net
    p = w["paths"]
    t_out, q_out = io.StringIO(), io.StringIO()
    chain_net(p["chain"], p["t_sizes"], p["q_sizes"], t_out, q_out,
              min_space=min_space, rescore=True, t_2bit=p["t2bit"],
              q_2bit=p["q2bit"], linear_gap="loose", **kw)
    return t_out.getvalue(), q_out.getvalue()


def _fills(w, t_net):
    """(fill lines, partial fills) of a target net: a fill is partial
    where it does not cover its chain's target range."""
    span = {c["id"]: (int(c["blocks"][0, 0]), int(c["blocks"][-1, 1]))
            for c in w["chains"]}
    fills = [ln.split() for ln in t_net.splitlines()
             if ln.lstrip().startswith("fill ")]
    partial = [f for f in fills
               if not (int(f[1]) <= span[int(f[8])][0]
                       and int(f[1]) + int(f[2]) >= span[int(f[8])][1])]
    return len(fills), len(partial)


@pytest.mark.parametrize("min_space", [1, 25])
@pytest.mark.parametrize("path", ["window", "hostnative", "per fill"])
def test_chainnet_phases_nest_and_counters_count(pair12, min_space, path,
                                                 monkeypatch):
    """A chain_net -rescore call is its four phases one after another,
    the scorer's `rescore: *` phases, the cut of the subsets among them,
    inside `chainnet: rescore fills`; the counters give the target net's
    fill lines and its partial fills, each scored once, on each path that
    scores them, and which path cut them, with the same bytes."""
    from genomealignmenttools_tpu_torch.engines.scoring import ChainScorer
    monkeypatch.delenv("GAT_RESCORE", raising=False)
    window = _chain_net(pair12, min_space, device="cpu")
    kw = {"device": "cpu"}
    if path == "hostnative":
        monkeypatch.setenv("GAT_RESCORE", "hostnative")
        kw = {}
    elif path == "per fill":         # a scorer without score_chains
        kw = {"scorer_factory": ChainScorer}
    perf_reset()
    (t_net, q_net), rec = recorded(lambda: _chain_net(pair12, min_space,
                                                      **kw))
    assert (t_net, q_net) == window
    fills, partial = _fills(pair12, t_net)
    assert partial == 2 * 12        # each broken chain's two fills
    assert PERF["chainnet_fills"] == fills
    assert PERF["chainnet_rescored_fills"] == partial
    per_fill = path == "per fill"   # the file's table, cut one by one
    assert PERF["chainnet_subsets_table"] == (0 if per_fill else partial)
    assert PERF["chainnet_subsets_python"] == (partial if per_fill else 0)
    spans = [(n, a, b) for n, a, b in rec.intervals if n in CHAINNET]
    assert [n for n, _, _ in spans] == CHAINNET
    for (_, _, b0), (_, a1, _) in zip(spans, spans[1:]):
        assert b0 <= a1
    (_, lo, hi) = spans[2]
    slack = 1e-3                # the recorder notes an end after the fact
    inner = [(a, b) for n, a, b in rec.intervals
             if n.startswith("rescore: ")]
    assert (path == "window") == bool(inner)
    assert (path == "window") == any(n == "rescore: cut subsets"
                                     for n, _, _ in rec.intervals)
    assert all(lo - slack <= a and b <= hi + slack for a, b in inner)


def test_chainnet_fill_lines_of_a_pruned_native_net():
    """The native writer leaves out a fill below the output thresholds
    with its subtree: the fill lines are then counted by depth."""
    import numpy as np

    from genomealignmenttools_tpu_torch.engines.chain_net import _fill_lines
    nodes = np.array([[0, 1, 0, 90, 0, 90, 0], [1, 2, 10, 50, 10, 50, 0],
                      [0, 3, 12, 40, 70, 98, 1], [1, 4, 20, 30, 80, 85, 1]],
                     np.int64)
    whole = (b"net chrT 100\n fill 0 90 chrQ + 0 90 id 1 score 9 ali 80\n"
             b"  gap 10 40 chrQ + 10 40\n"
             b"   fill 12 28 chrQ + 70 28 id 2 score 3 ali 18\n"
             b"    gap 20 10 chrQ + 80 5\n")
    assert _fill_lines(memoryview(whole), nodes, 1) == 2
    pruned = whole[:whole.index(b"   fill")]
    assert _fill_lines(memoryview(pruned), nodes, 1) == 1
