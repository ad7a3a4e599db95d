"""patchChain on the staged, batched gap path, on the CPU.

The port's patch_chain runs a chunk of gaps at a time through RepeatFiller's
stages (engines/repeat_filler.py `_gap_jobs_hsps`), with each gap's masked
seed codes, and one band batch a chunk.  On the fixtures and on a small
planted case of soft-masked gaps scored with HoxD55 (W=5, K=1500, L=2500),
masked and under -unmask, with the chunk cut to two gaps so that several
chunks run, its psl is byte for byte that of the per-gap path
(GAT_RF_BATCH=0) and that of the JAX package's patch_chain; the counters
`pc_*` and the phases `pc: *` say what ran.  Under masked seeding the port
keeps no HSP that holds no seed word, where the JAX package's aligner keeps
every segment of a scan window; these cases hold no such segment, and
test_masked_seeding_keeps_no_seedless_hsp plants one.
"""

import io
import os

import numpy as np
import pytest
import torch

from genomealignmenttools_tpu.engines.drivers import \
    patch_chain as ref_patch_chain
from genomealignmenttools_tpu_torch.device import LAUNCHES, PERF, perf_reset
from genomealignmenttools_tpu_torch.engines import drivers
from genomealignmenttools_tpu_torch.engines import repeat_filler as rf
from genomealignmenttools_tpu_torch.formats.twobit import write_twobit
from genomealignmenttools_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
HOXD55 = os.path.join(FIX, "HoxD55.q")
PHASES = ("patchchain", "pc: read + harvest", "pc: seed", "pc: hsp scan",
          "pc: band problems", "pc: gapped finish", "pc: axt + psl")
N_GAPS = 6
CHUNK = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain band DP is many small torch ops; under the parallel test
    runner, torch's intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mutate(rng, seq: np.ndarray, identity: float) -> np.ndarray:
    out = seq.copy()
    mut = rng.random(len(seq)) > identity
    out[mut] = rng.integers(0, 4, int(mut.sum()))
    return out


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """A chain of N_GAPS gaps of 1,200-1,800 bases a side (700 more in
    every other gap), every 300-base run of a gap soft-masked with
    probability 1/2; each gap hides two unmasked 150-base pieces at 70%,
    1-3 target bases apart, and every other gap a masked 150-base piece
    at its end, its target masked from 1,010 bases before it and 800
    bases of query between it and the unmasked pieces."""
    d = tmp_path_factory.mktemp("pc_planted")
    rng = np.random.default_rng(24)
    anchor = 400
    tg = rng.integers(1200, 1801, N_GAPS)
    qg = rng.integers(1200, 1801, N_GAPS)
    tg[1::2] += 700            # room for the masked piece and its guard
    qg[1::2] += 700
    t_len = 500 + (N_GAPS + 1) * anchor + int(tg.sum()) + 500
    q_len = 500 + (N_GAPS + 1) * anchor + int(qg.sum()) + 500
    t = rng.integers(0, 4, t_len)
    q = rng.integers(0, 4, q_len)
    t_mask = np.zeros(t_len, bool)
    q_mask = np.zeros(q_len, bool)
    rows = []
    tp = qp = 500
    for k in range(N_GAPS):
        q[qp:qp + anchor] = _mutate(rng, t[tp:tp + anchor], 0.85)
        rows.append((tp, qp))
        tp, qp = tp + anchor, qp + anchor
        for mask, lo, n in ((t_mask, tp, tg[k]), (q_mask, qp, qg[k])):
            for s in range(lo, lo + n, 300):
                mask[s:min(s + 300, lo + n)] = rng.random() < 0.5
        t_room, q_room = int(tg[k]), int(qg[k])
        if k % 2:
            mt, mq = tp + int(tg[k]) - 160, qp + int(qg[k]) - 170
            q[mq:mq + 150] = _mutate(rng, t[mt:mt + 150], 0.7)
            t_mask[mt - 1010:tp + int(tg[k])] = True
            q_mask[mq:mq + 150] = True
            t_room, q_room = mt - 1010 - tp, mq - 800 - qp
        shift = 1 + k % 3
        ta = tp + int(rng.integers(0, t_room - 300 - shift))
        qa = qp + int(rng.integers(0, q_room - 300))
        q[qa:qa + 150] = _mutate(rng, t[ta:ta + 150], 0.7)
        q[qa + 150:qa + 300] = _mutate(
            rng, t[ta + 150 + shift:ta + 300 + shift], 0.7)
        t_mask[ta:ta + 300 + shift] = False
        q_mask[qa:qa + 300] = False
        tp, qp = tp + int(tg[k]), qp + int(qg[k])
    q[qp:qp + anchor] = _mutate(rng, t[tp:tp + anchor], 0.85)
    rows.append((tp, qp))
    letters = np.frombuffer(b"ACGT", np.uint8)

    def chars(codes, mask):
        c = letters[codes].copy()
        c[mask] |= 0x20
        return c.tobytes()
    paths = [str(d / n) for n in ("in.chain", "t.2bit", "q.2bit",
                                  "t.sizes", "q.sizes")]
    write_twobit(paths[1], [("chrT", chars(t, t_mask))])
    write_twobit(paths[2], [("chrQ", chars(q, q_mask))])
    with open(paths[3], "w") as f:
        f.write(f"chrT\t{t_len}\n")
    with open(paths[4], "w") as f:
        f.write(f"chrQ\t{q_len}\n")
    lines = [f"chain 1000000 chrT {t_len} + {rows[0][0]} "
             f"{rows[-1][0] + anchor} chrQ {q_len} + {rows[0][1]} "
             f"{rows[-1][1] + anchor} 1"]
    for (t0, q0), (t1, q1) in zip(rows[:-1], rows[1:]):
        lines.append(f"{anchor}\t{t1 - t0 - anchor}\t{q1 - q0 - anchor}")
    lines.append(f"{anchor}\n")
    with open(paths[0], "w") as f:
        f.write("\n".join(lines) + "\n")
    return paths


def _fixture_inputs():
    return [os.path.join(FIX, n) for n in (
        "repeatfiller_input.chain", "target.2bit", "query.2bit",
        "target.chrom.sizes", "query.chrom.sizes")]


def _settings(case, unmask):
    kw = {"unmask": unmask}
    if case == "planted":
        kw.update(score_scheme=HOXD55, seed_len=5, hsp_threshold=1500,
                  gapped_threshold=2500)
    return kw


def _port(inputs, kw):
    out = io.StringIO()
    perf_reset()
    profiling.phase_acc_start()
    try:
        drivers.patch_chain(*inputs, out, device="cpu", **kw)
    finally:
        phases = profiling.phase_acc_stop()
    return out.getvalue(), dict(PERF), dict(LAUNCHES), phases


@pytest.mark.parametrize("unmask", [False, True], ids=["masked", "unmask"])
@pytest.mark.parametrize("case", ["fixtures", "planted"])
def test_batched_psl_is_per_gap_and_reference_psl(case, unmask, planted,
                                                  monkeypatch):
    inputs = planted if case == "planted" else _fixture_inputs()
    kw = _settings(case, unmask)
    monkeypatch.setattr(drivers, "_gap_chunks",
                        lambda jobs: rf._gap_chunks(jobs, CHUNK))
    batched, perf, _, phases = _port(inputs, kw)
    monkeypatch.setenv("GAT_RF_BATCH", "0")
    per_gap, perf1, _, _ = _port(inputs, kw)
    want = io.StringIO()
    ref_patch_chain(*inputs, want, **kw)
    assert batched == per_gap == want.getvalue()
    n = perf["pc_gaps"]
    assert n == perf1["pc_gaps"] > 0
    assert perf["pc_band_problems"] == perf1["pc_band_problems"] \
        == perf["band_problems"]
    assert perf["pc_psl_records"] == perf1["pc_psl_records"] \
        == batched.count("\n")
    # one band batch a chunk that holds a gap with a problem, a gap a run
    # on the per-gap path
    assert perf1["pc_band_runs"] <= n
    assert perf["pc_band_runs"] <= -(-n // CHUNK)
    assert set(PHASES) <= set(phases)
    if case == "planted":
        assert n == N_GAPS
        assert perf["pc_band_runs"] == N_GAPS // CHUNK
        assert perf1["pc_band_runs"] == N_GAPS
        assert batched.count("\n") >= 2 * N_GAPS


def test_unmask_finds_the_masked_pieces(planted):
    """Masked seeding skips the pieces that lie wholly in soft-masked
    sequence; -unmask aligns them too."""
    masked, _, _, _ = _port(planted, _settings("planted", False))
    unmasked, _, _, _ = _port(planted, _settings("planted", True))

    def t_ends(text):
        return {int(ln.split("\t")[16]) for ln in text.splitlines()}
    extra = t_ends(unmasked) - t_ends(masked)
    assert len(extra) >= N_GAPS // 2


def test_one_chunk_is_one_band_run(planted):
    """At the default chunk (4,096 gaps) the planted gaps are one chunk and
    one band batch: one pass of the band wrapper and one of the HSP scan's,
    which on the card are one K3 and one K4 launch (here the plain
    versions, LAUNCHES untouched)."""
    _, perf, launches, _ = _port(planted, _settings("planted", False))
    assert perf["pc_gaps"] == N_GAPS and perf["pc_band_runs"] == 1
    assert perf["dispatches"] == 2
    assert launches["band_ext"] == launches["hsp_best"] == 0
    assert perf["hsp_windows_device"] > 0 == perf["hsp_windows_host"]


def test_repeat_filler_phase_names_are_unchanged(tmp_path):
    """RepeatFiller runs the shared stages under its own `rf: *` names, and
    none of patchChain's."""
    profiling.phase_acc_start()
    try:
        rf.repeat_filler(*_fixture_inputs()[:3], str(tmp_path / "o.chain"),
                         device="cpu")
    finally:
        phases = profiling.phase_acc_stop()
    assert {"repeatfiller", "rf: read + harvest", "rf: seed",
            "rf: hsp scan", "rf: band problems", "rf: gapped finish",
            "rf: chain", "rf: splice + write"} <= set(phases)
    assert not [p for p in phases if p.startswith("pc") or
                p == "patchchain"]


def _hoxd55_aligner(package):
    from importlib import import_module
    sm = import_module(f"{package}.formats.scorematrix")
    se = import_module(f"{package}.ops.seed_extend")
    sch = sm.read_score_scheme(HOXD55)
    kw = {"device": "cpu"} if package.endswith("_torch") else {}
    return se.GapAligner(sch.lut, seed_len=5, hsp_threshold=1500, **kw)


@pytest.mark.parametrize("package,unmask,found", [
    ("genomealignmenttools_tpu_torch", False, False),
    ("genomealignmenttools_tpu_torch", True, True),
    ("genomealignmenttools_tpu", False, True)],
    ids=["port-masked", "port-unmask", "reference-masked"])
def test_masked_seeding_keeps_no_seedless_hsp(package, unmask, found):
    """A 150-base piece at 70% wholly in soft-masked sequence, 400 bases
    along its diagonal from an unmasked exact 12-base word: the word seeds
    a scan window that covers the piece.  The port's masked seeding keeps
    no HSP that holds no seed word, as lastz grows every HSP from one
    (-unmask seeds the piece itself); the reference package's aligner,
    which keeps every segment of a window, aligns it."""
    rng = np.random.default_rng(11)
    n, d, word, piece = 3000, 200, 800, 1200
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = rng.integers(0, 4, n).astype(np.uint8)
    q[word - d:word - d + 12] = t[word:word + 12]
    q[piece - d:piece - d + 150] = _mutate(rng, t[piece:piece + 150], 0.7)
    t_seed, q_seed = t.copy(), q.copy()
    t_seed[word + 12:] = 4                  # all masked past the word
    q_seed[word - d + 12:] = 4
    seeds = {} if unmask else {"t_seed_codes": t_seed,
                               "q_seed_codes": q_seed}
    got = _hoxd55_aligner(package).align(t, q, 0, n, 0, n, **seeds)
    on_piece = [b for b in got if b[0] < piece + 150 and b[1] > piece
                and b[0] - b[2] == d]
    assert bool(on_piece) is found
