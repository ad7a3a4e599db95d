"""RepeatFiller's chaining stage in one native call a chunk
(ops/chain_pairs.py over native/chainpairs.cpp) against the per-gap Python
path it replaces (engines/repeat_filler._gap_job_chains: chain_pair, then
chainSort), chain by chain: blocks, score, every header field and the order.

The hand-made gaps reach each repair of chainRemovePartialOverlaps that
rows can reach (a crossover that moves a block's start, a block trimmed
away whole, blocks left abutting and merged), and a gap without HSPs, a gap
whose chains all fall under the minimum score, a gap whose chains the
exact rescoring reorders and a `-` strand gap; each test checks through the
Python pieces that its case reaches its branch.
The total trim of the left block, with its restart, is implemented in both
paths but cannot be reached: the crossover leaves each block at least one
base of the overlap it was given, so neither block's query span can close.
Of the two conditions that trim the right block whole, only the left block's
being no longer than the overlap is reached (its start moved by the repair
of the pair before): the DP chains no block enclosed by its neighbour's
overlap, and the repair never moves a left block's end before a trim.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.engines import chain_connect as cc
from genomealignmenttools_tpu_torch.engines import repeat_filler as rf
from genomealignmenttools_tpu_torch.engines.axt_chain import SeqPair, \
    chain_pair
from genomealignmenttools_tpu_torch.engines.kd_chainer import \
    chain_blocks_arrays
from genomealignmenttools_tpu_torch.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu_torch.formats.scorematrix import \
    score_scheme_default
from genomealignmenttools_tpu_torch.native import get_lib
from genomealignmenttools_tpu_torch.ops import chain_pairs as cp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEME = score_scheme_default()
GAPS = gap_calc_from_file("loose")
MIN_SCORE = 1000
FIELDS = ("score", "t_name", "t_size", "t_start", "t_end", "q_name",
          "q_size", "q_strand", "q_start", "q_end", "id")

# (target codes, query codes, HSP rows [tS, tE, qS, qE]) of each repair
CASES = {
    "crossover": (
        "1120213323010233133010130133320300333320122033311223303300303101"
        "32301213031121021233222111",
        "1120213123010233133010130133320300333320322033311223303300003100"
        "30132301213031121021233222",
        [[9, 39, 9, 39], [25, 73, 25, 73], [60, 83, 63, 86]]),
    "merge": (
        "3000033200112110220011321122023331122231300331010322010310122110"
        "22233022011212201332020331331310232131100231230122",
        "3000033200112110220011121122023331122231300331010322010310122110"
        "22233022011212200133202033133131023213111023123012",
        [[5, 53, 5, 53], [40, 75, 40, 75], [67, 110, 67, 110]]),
    "trim_b": (
        "1211302331233232311202133202032102232111303100103300300312201001"
        "2230020003332232032102000201112030120110311300312020022110321121"
        "10331322102031302211201223000130",
        "1211302331233232311202133202032102232111303100103300300312213220"
        "1031222002000333223203210200020111003012011031130131202002211032"
        "11211033132210203130221120122300",
        [[18, 62, 18, 62], [64, 101, 68, 105], [91, 109, 91, 109],
         [103, 155, 107, 159]]),
}

# a gap whose chains the rescoring reorders: the DP ranks them one way, the
# exact scores after the repair the other, so chainSort has work to do
RESORT = (
        "2123233232122103123131002131121001133321013300231102302120300013"
        "1211010321000302330302301112331002300001333003113111020220113102"
        "1013021102323031333121331222333010331001212032122132030212011003"
        "12321021",
        "2103233232122103123131002231131001133322013000231102302120300213"
        "1211010322000302323302301112331002300001333003113111020230113102"
        "1110121302110212303131312133122233301033100121203212213203021201"
        "10021232",
    [[14, 43, 14, 43], [137, 175, 141, 179], [109, 153, 113, 157],
     [128, 173, 128, 173], [130, 173, 134, 177], [76, 90, 76, 90]])

def _codes(digits):
    return np.frombuffer(digits.encode(), np.uint8) - ord("0")


def _job(strand="+"):
    return rf.GapJob(0, 0, 1, 1, 1, 1, "t", "q", strand, 0)


def _repairs(t, q, rows):
    """What the Python repair does to the DP's chains of `rows`."""
    lut = np.asarray(SCHEME.lut)
    scored = [[*r, cc.score_block_codes(q, t, r[2], r[0], r[1] - r[0], lut)]
              for r in rows]
    seen = set()
    for chain in chain_blocks_arrays("q", q.size, "+", "t", t.size, scored,
                                     q, t, lut, GAPS):
        before = [list(r[:4]) for r in chain._rows]
        after = cc.remove_partial_overlaps([list(b) for b in before], q, t,
                                           lut)
        if len(after) < len(before):
            seen.add("trim_b")
        starts = {(b[0], b[2]) for b in before}
        if any((b[0], b[2]) not in starts for b in after):
            seen.add("crossover")
        if len(cc.merge_abutting([list(b) for b in after])) < len(after):
            seen.add("merge")
    return seen


def _assert_same(want, got):
    assert len(got) == len(want)
    for ws, gs in zip(want, got):
        assert len(gs) == len(ws)
        for w, g in zip(ws, gs):
            for f in FIELDS:
                assert getattr(g, f) == getattr(w, f), f
                assert type(getattr(g, f)) is type(getattr(w, f)), f
            assert g.blocks.dtype == w.blocks.dtype
            assert np.array_equal(g.blocks, w.blocks)
            assert g.to_text() == w.to_text()


def _python(jobs, hsps_all, ctxs):
    return [rf._gap_job_chains(job, hsps, *ctx, SCHEME, GAPS, MIN_SCORE)
            for job, hsps, ctx in zip(jobs, hsps_all, ctxs)]


def _hand_made():
    """jobs, rows and contexts of the hand-made gaps, and each gap's name."""
    names, jobs, hsps_all, ctxs = [], [], [], []
    for name, (t, q, rows) in CASES.items():
        t, q = _codes(t), _codes(q)
        for strand in ("+", "-"):
            names.append(f"{name}{strand}")
            jobs.append(_job(strand))
            hsps_all.append([[*r, 0] for r in rows])
            ctxs.append((t, q, t.size, q.size))
    t, q = _codes(RESORT[0]), _codes(RESORT[1])
    names.append("resort")
    jobs.append(_job())
    hsps_all.append([[*r, 0] for r in RESORT[2]])
    ctxs.append((t, q, t.size, q.size))
    t, q = _codes(CASES["merge"][0]), _codes(CASES["merge"][1])
    names.append("no HSPs")
    jobs.append(_job())
    hsps_all.append([])
    ctxs.append((t, q, t.size, q.size))
    names.append("under min_score")
    jobs.append(_job())
    hsps_all.append([[10, 15, 7, 12, 0], [30, 35, 27, 32, 0]])
    ctxs.append((t, q, t.size, q.size))
    return names, jobs, hsps_all, ctxs


@pytest.mark.parametrize("name", sorted(CASES))
def test_hand_made_case_reaches_its_repair(name):
    t, q, rows = CASES[name]
    assert name in _repairs(_codes(t), _codes(q), rows)


def test_resort_case_needs_the_final_sort():
    t, q, rows = RESORT
    sp = SeqPair("q", "t", "+")
    sp.rows = [list(r) for r in rows]
    scores = [c.score for c in chain_pair(sp, _codes(q), _codes(t), len(q),
                                          len(t), SCHEME, GAPS, MIN_SCORE)]
    assert len(scores) > 1 and scores != sorted(scores, reverse=True)


@pytest.mark.parametrize("n_threads", [1, 8])
def test_native_batch_matches_python_on_hand_made_gaps(n_threads):
    assert get_lib() is not None
    names, jobs, hsps_all, ctxs = _hand_made()
    want = _python(jobs, hsps_all, ctxs)
    got = cp.chain_gap_hsps(jobs, hsps_all, ctxs, SCHEME, GAPS, MIN_SCORE,
                            n_threads=n_threads)
    _assert_same(want, got)
    by_name = dict(zip(names, want))
    assert by_name["no HSPs"] == []
    # the DP does chain the low gap's rows; every chain is under the limit
    t, q = ctxs[-1][0], ctxs[-1][1]
    lut = np.asarray(SCHEME.lut)
    rows = [[*h[:4], cc.score_block_codes(q, t, h[2], h[0], h[1] - h[0],
                                          lut)] for h in hsps_all[-1]]
    assert chain_blocks_arrays("q", q.size, "+", "t", t.size, rows, q, t,
                               lut, GAPS)
    assert by_name["under min_score"] == []
    for name in CASES:
        assert by_name[f"{name}+"], name
        assert [c.q_strand for c in by_name[f"{name}-"]] == \
            ["-"] * len(by_name[f"{name}+"])


def test_refused_rows_leave_the_chunk_to_python():
    """A row outside its sequences makes the call answer None, so the
    caller chains the chunk in Python, as before."""
    _, jobs, hsps_all, ctxs = _hand_made()
    t = ctxs[0][0]
    bad = [list(h) for h in hsps_all[0]] + [[t.size - 2, t.size + 3, 0, 5, 0]]
    assert cp.chain_gap_hsps(jobs[:1], [bad], ctxs[:1], SCHEME, GAPS,
                             MIN_SCORE) is None


def _capture(monkeypatch):
    """Record every chunk the engine hands to the native chaining."""
    seen = []
    real = cp.chain_gap_hsps

    def recording(batch, hsps_all, ctxs, *args, **kw):
        seen.append((list(batch), [list(h) for h in hsps_all], list(ctxs)))
        return real(batch, hsps_all, ctxs, *args, **kw)

    monkeypatch.setattr(rf, "chain_gap_hsps", recording)
    return seen


def _rf_inputs(name, fixtures_dir, tmp_path):
    if name == "fixtures":
        return (os.path.join(fixtures_dir, "repeatfiller_input.chain"),
                os.path.join(fixtures_dir, "target.2bit"),
                os.path.join(fixtures_dir, "query.2bit"))
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_repeatfiller_workload
    m = build_repeatfiller_workload(str(tmp_path / "rf"), n_gaps=24)
    return m["chain"], m["t2bit"], m["q2bit"]


def _run(inputs, out, **kw):
    rf.repeat_filler(*inputs, out, device="cpu", **kw)
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("inputs", ["fixtures", "workload24"])
def test_native_batch_matches_python_in_repeatfiller(inputs, fixtures_dir,
                                                     tmp_path, monkeypatch):
    """Every chunk that RepeatFiller chains, at 1 and 8 threads, against the
    Python path on the same rows; the counters name the path taken, and the
    Python fallback (no native library, as under GAT_NATIVE=0) writes the
    same bytes."""
    monkeypatch.setenv("GAT_BAND", "host")
    paths = _rf_inputs(inputs, fixtures_dir, tmp_path)
    with open(paths[0]) as f:
        n_jobs = len(rf.harvest_gap_jobs(
            [ln + "\n" for ln in f.read().split("\n")]))
    assert n_jobs > 0
    seen = _capture(monkeypatch)
    perf_reset()
    native = _run(paths, str(tmp_path / "native.chain"))
    assert PERF["rf_chain_native_pairs"] == n_jobs
    assert PERF["rf_chain_python_pairs"] == 0
    assert sum(len(batch) for batch, _, _ in seen) == n_jobs
    strands = set()
    for batch, hsps_all, ctxs in seen:
        want = _python(batch, hsps_all, ctxs)
        for n_threads in (1, 8):
            _assert_same(want, cp.chain_gap_hsps(
                batch, hsps_all, ctxs, SCHEME, GAPS, MIN_SCORE,
                n_threads=n_threads))
        strands |= {c.q_strand for chains in want for c in chains}
    # the fixtures' second chain is on the query's - strand
    assert strands == ({"+", "-"} if inputs == "fixtures" else {"+"})
    monkeypatch.setattr(cp, "get_lib", lambda: None)
    perf_reset()
    assert _run(paths, str(tmp_path / "python.chain")) == native
    assert PERF["rf_chain_native_pairs"] == 0
    assert PERF["rf_chain_python_pairs"] == n_jobs


_CHILD = """
import json, sys
from genomealignmenttools_tpu_torch.device import PERF
from genomealignmenttools_tpu_torch.engines.repeat_filler import repeat_filler
repeat_filler(*sys.argv[1:5], device="cpu")
print(json.dumps({k: PERF[k] for k in ("rf_chain_native_pairs",
                                       "rf_chain_python_pairs")}))
"""


def test_thread_counts_and_native_off_write_the_same_bytes(tmp_path,
                                                           monkeypatch):
    """RepeatFiller on the 24 gaps in fresh processes at GAT_THREADS=1 and
    8 (the native library reads it once a process) and at GAT_NATIVE=0,
    side by side: the bytes of the in-process Python path, and the counters
    of the path each took."""
    from conftest import hermetic_cpu_env
    monkeypatch.setenv("GAT_BAND", "host")
    paths = _rf_inputs("workload24", None, tmp_path)
    with open(paths[0]) as f:
        n_jobs = len(rf.harvest_gap_jobs(
            [ln + "\n" for ln in f.read().split("\n")]))
    monkeypatch.setattr(cp, "get_lib", lambda: None)
    want = _run(paths, str(tmp_path / "python.chain"))
    env = {**hermetic_cpu_env(), "GAT_BAND": "host", "OMP_NUM_THREADS": "1"}
    settings = {"threads1": {"GAT_THREADS": "1"},
                "threads8": {"GAT_THREADS": "8"},
                "native0": {"GAT_NATIVE": "0"}}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _CHILD, *paths, str(tmp_path / f"{name}.chain")],
        env={**env, **extra}, cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for name, extra in settings.items()}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        counts = json.loads(out.strip().splitlines()[-1])
        assert (tmp_path / f"{name}.chain").read_bytes() == want, name
        native = name != "native0"
        assert counts["rf_chain_native_pairs"] == (n_jobs if native else 0)
        assert counts["rf_chain_python_pairs"] == (0 if native else n_jobs)
