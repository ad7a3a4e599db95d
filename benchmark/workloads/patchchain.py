"""The patchChain workload: one chain whose gaps hide diverged homologs
between soft-masked repeats, made from a seed.

A distant-species pair (the README's hg38-danRer10) seen through one chain
of `n_gaps` gaps:
- anchor blocks of 500 bases at 85% identity, one before and after each
  gap; each gap's length drawn uniformly from 1,000-4,000 bases, on each
  side apart;
- about half of each gap's target and query bases soft-masked (lowercase in
  the 2bit), in runs of 300 bases: each 300-base run is masked with
  probability 1/2 (hg38 and danRer10 are each about half repeat);
- in every gap two unmasked homologous pieces of 150 bases at 70% identity
  (coding-exon identity between human and fish), the second 1-3 target
  bases after the first, so that only the gapped extension joins them;
- in one gap in four of at least 2,000 bases on both sides, one more
  150-base piece at 70% that lies wholly in soft-masked sequence: at least
  SEP=800 bases past the unmasked pair on both sides, and masked with
  GUARD=300 bases of mask before and after it on both sides (clipped to
  the gap), so that no unmasked seed lies within 300 bases of it along
  its diagonal.  Masked seeding grows no HSP in it: an ungapped extension
  from a seed would have to cross 300 masked chance bases (about -30 a
  base with HoxD55) within lastz's x-drop.  A gapped extension may still
  run into it, as lastz's may within its y-drop, and the check counts
  only alignments seeded from nowhere.  Seeding through the mask
  (`[unmask]`) finds it.

The returned dict holds the file paths (chain, both 2bit files with their
mask blocks, both chrom.sizes files), the work units of one call (`gaps`),
the genome codes and masks, the chain, and the plan that the check reads:
each gap's window (`gaps`: t_lo, t_hi, q_lo, q_hi, the gap itself), its
unmasked pieces (`pieces`: per gap, rows of target start, query start,
length) and the masked pieces (`masked`: rows of gap, target start, query
start, length).  The 2bit writer here writes mask blocks, which
lib/seqfiles.write_twobit does not."""

from __future__ import annotations

import os
import struct

import numpy as np

from ..lib.seqfiles import TWOBIT_SIGNATURE, chain_text

ANCHOR, ANCHOR_ID = 500, 0.85
GAP_MIN, GAP_MAX = 1000, 4000
MASK_RUN = 300
PIECE, PIECE_ID = 150, 0.70
MASKED_GAP_MIN, MASKED_EVERY = 2000, 4
SEP = 800           # bases between the unmasked pair and the masked piece
GUARD = 300         # masked bases on each side of the masked piece
LEAD, TAIL = 1000, 20_000


def _plant(rng, t_codes, q_codes, tp, qp, length, identity):
    frag = t_codes[tp:tp + length].copy()
    mut = rng.random(length) > identity
    frag[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)
    q_codes[qp:qp + length] = frag


def _mask_runs(rng, mask, lo, hi):
    """Each MASK_RUN-base run of [lo, hi) masked with probability 1/2."""
    starts = np.arange(lo, hi, MASK_RUN)
    for s in starts[rng.random(len(starts)) < 0.5]:
        mask[s:min(s + MASK_RUN, hi)] = True


def mask_blocks(mask: np.ndarray) -> np.ndarray:
    """(start, size) rows of the runs of True in mask."""
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], mask.view(np.int8), [0]])))
    starts, ends = edges[0::2], edges[1::2]
    return np.stack([starts, ends - starts], 1).astype(np.int64)


def write_twobit_masked(path: str, name: str, codes: np.ndarray,
                        mask: np.ndarray) -> None:
    """One sequence with its soft-mask blocks and no N blocks; four bases
    a byte, the first in the high bits (the kent 2bit format)."""
    n = int(codes.size)
    if n % 4:
        codes = np.concatenate([codes, np.zeros(4 - n % 4, np.uint8)])
    w = np.ascontiguousarray(codes).view("<u4")
    packed = (((w & 3) << 6) | ((w >> 4) & 0x30) | ((w >> 14) & 0xC)
              | ((w >> 24) & 3)).astype(np.uint8)
    blocks = mask_blocks(mask)
    nb = name.encode()
    offset = 16 + 1 + len(nb) + 4
    with open(path, "wb") as f:
        f.write(struct.pack("<IIII", TWOBIT_SIGNATURE, 0, 1, 0))
        f.write(struct.pack("<B", len(nb)) + nb + struct.pack("<I", offset))
        f.write(struct.pack("<III", n, 0, len(blocks)))
        f.write(blocks[:, 0].astype("<u4").tobytes())
        f.write(blocks[:, 1].astype("<u4").tobytes())
        f.write(struct.pack("<I", 0))
        f.write(packed.tobytes())


def generate(seed: int, params: dict, out_dir: str) -> dict:
    n_gaps = int(params["n_gaps"])
    rng = np.random.default_rng(seed)
    t_gaps = rng.integers(GAP_MIN, GAP_MAX + 1, n_gaps)
    q_gaps = rng.integers(GAP_MIN, GAP_MAX + 1, n_gaps)
    t_size = LEAD + (n_gaps + 1) * ANCHOR + int(t_gaps.sum()) + TAIL
    q_size = LEAD + (n_gaps + 1) * ANCHOR + int(q_gaps.sum()) + TAIL
    t_codes = np.frombuffer(rng.bytes(t_size), np.uint8) & 3
    q_codes = np.frombuffer(rng.bytes(q_size), np.uint8) & 3
    t_mask = np.zeros(t_size, bool)
    q_mask = np.zeros(q_size, bool)
    blocks, gaps, pieces, masked = [], [], [], []
    tp = qp = LEAD
    big = 0          # gaps of at least MASKED_GAP_MIN on both sides so far
    for k in range(n_gaps):
        _plant(rng, t_codes, q_codes, tp, qp, ANCHOR, ANCHOR_ID)
        blocks.append((tp, tp + ANCHOR, qp, qp + ANCHOR))
        tp += ANCHOR
        qp += ANCHOR
        tg, qg = int(t_gaps[k]), int(q_gaps[k])
        gaps.append((tp, tp + tg, qp, qp + qg))
        _mask_runs(rng, t_mask, tp, tp + tg)
        _mask_runs(rng, q_mask, qp, qp + qg)
        shift = 1 + int(rng.integers(0, 3))
        pair_t, pair_q = 2 * PIECE + shift, 2 * PIECE
        hidden = (tg >= MASKED_GAP_MIN and qg >= MASKED_GAP_MIN
                  and big % MASKED_EVERY == 0)
        big += tg >= MASKED_GAP_MIN and qg >= MASKED_GAP_MIN
        room_t = tg - pair_t - (SEP + PIECE if hidden else 0)
        room_q = qg - pair_q - (SEP + PIECE if hidden else 0)
        ta = tp + int(rng.integers(0, room_t + 1))
        qa = qp + int(rng.integers(0, room_q + 1))
        if hidden:
            mt = ta + pair_t + SEP + int(
                rng.integers(0, tp + tg - PIECE - (ta + pair_t + SEP) + 1))
            mq = qa + pair_q + SEP + int(
                rng.integers(0, qp + qg - PIECE - (qa + pair_q + SEP) + 1))
            _plant(rng, t_codes, q_codes, mt, mq, PIECE, PIECE_ID)
            t_mask[max(tp, mt - GUARD):min(tp + tg, mt + PIECE + GUARD)] = 1
            q_mask[max(qp, mq - GUARD):min(qp + qg, mq + PIECE + GUARD)] = 1
            masked.append((k, mt, mq, PIECE))
        rows = [(ta, qa, PIECE), (ta + PIECE + shift, qa + PIECE, PIECE)]
        for pt, pq, n in rows:
            _plant(rng, t_codes, q_codes, pt, pq, n, PIECE_ID)
        t_mask[ta:ta + pair_t] = False
        q_mask[qa:qa + pair_q] = False
        pieces.append(np.array(rows, np.int64))
        tp += tg
        qp += qg
    _plant(rng, t_codes, q_codes, tp, qp, ANCHOR, ANCHOR_ID)
    blocks.append((tp, tp + ANCHOR, qp, qp + ANCHOR))
    chain = {"score": 10_000_000, "t_name": "chrT", "t_size": t_size,
             "q_name": "chrQ", "q_size": q_size, "q_strand": "+", "id": 1,
             "blocks": np.array(blocks, np.int64)}
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, v) for k, v in (
        ("chain", "in.chain"), ("t2bit", "t.2bit"), ("q2bit", "q.2bit"),
        ("t_sizes", "t.chrom.sizes"), ("q_sizes", "q.chrom.sizes"))}
    write_twobit_masked(paths["t2bit"], "chrT", t_codes, t_mask)
    write_twobit_masked(paths["q2bit"], "chrQ", q_codes, q_mask)
    with open(paths["chain"], "w") as f:
        f.write(chain_text([chain]))
    for key, name, size in (("t_sizes", "chrT", t_size),
                            ("q_sizes", "chrQ", q_size)):
        with open(paths[key], "w") as f:
            f.write(f"{name}\t{size}\n")
    return {"paths": paths, "units": {"gaps": n_gaps}, "t_codes": t_codes,
            "q_codes": q_codes, "t_mask": t_mask, "q_mask": q_mask,
            "chains": [chain], "gaps": np.array(gaps, np.int64),
            "pieces": pieces,
            "masked": np.array(masked, np.int64).reshape(-1, 4)}
