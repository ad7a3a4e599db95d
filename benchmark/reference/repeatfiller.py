"""RepeatFiller's output on the planted workload, judged by what it says.

The chain keeps its header and every one of its blocks.  Each gap may gain
blocks, which have to lie inside it, in order, and:
- align the planted homolog: every aligned pair on the diagonal of the
  planted piece its query base belongs to (the nearest piece outside them).
  lastz may also chain a chance alignment in the random sequence around
  the homolog, which is off it, so this is a count with a limit;
- score no more than a little below 0 in any added block of
  LONG_BLOCK bases or more: the gapped extension may bridge a short weak
  stretch, but a block moved off its alignment scores about -44 a base;
- score at least the configuration's threshold as a chain of their own
  (kent's chain score with the configuration's matrix and gap costs);
- cover the planted homolog: the share of its pairs (each planted piece's
  bases with their planted partners) that no added block aligns.  A fill
  that stops at the first indel, or leaves out the pieces that only the
  gapped extension joins, misses about three quarters of them.
Every gap has a planted homolog far above the threshold, so every gap is
filled."""

from __future__ import annotations

import os

import numpy as np

from .common import read_chains, scorer, write_chains

LONG_BLOCK = 20    # bases: a block beside an indel may be shorter


def _fills(chain: dict, got: dict):
    """(misplaced, fills): misplaced counts a changed header or a missing,
    moved or overlapping block; fills[k] are the blocks added to gap k."""
    want = chain["blocks"]
    misplaced = int(any(got[k] != chain[k] for k in (
        "t_name", "t_size", "q_name", "q_size", "q_strand", "id")))
    b = got["blocks"]
    misplaced += int((b[1:, 0] < b[:-1, 1]).sum()
                     + (b[1:, 2] < b[:-1, 3]).sum())
    is_anchor = np.zeros(len(b), bool)
    pos = {tuple(r): i for i, r in enumerate(b.tolist())}
    at = [pos.get(tuple(r)) for r in want.tolist()]
    misplaced += sum(1 for i in at if i is None)
    fills = []
    for k in range(len(want) - 1):
        lo, hi = at[k], at[k + 1]
        if lo is None or hi is None or hi < lo:
            fills.append(np.zeros((0, 4), np.int64))
            continue
        is_anchor[lo] = is_anchor[hi] = True
        fills.append(b[lo + 1:hi])
    misplaced += int((~is_anchor).sum() - sum(len(f) for f in fills))
    return misplaced, fills


def _off_homolog(fill: np.ndarray, pieces: np.ndarray) -> int:
    """Aligned pairs of a fill that are not on the diagonal of the planted
    piece their query base belongs to."""
    q, t = _pairs(fill)
    j = np.clip(np.searchsorted(pieces[:, 1], q, "right") - 1, 0,
                len(pieces) - 1)
    return int((t - q != pieces[j, 0] - pieces[j, 1]).sum())


def _pairs(blocks: np.ndarray):
    """(q, t) of every aligned pair of blocks (rows t0, t1, q0, q1), in the
    blocks' order."""
    sizes = blocks[:, 1] - blocks[:, 0]
    ar = np.arange(int(sizes.sum()), dtype=np.int64)
    first = np.cumsum(sizes) - sizes
    return (np.repeat(blocks[:, 2] - first, sizes) + ar,
            np.repeat(blocks[:, 0] - first, sizes) + ar)


def _missed(fill: np.ndarray, pieces: np.ndarray) -> int:
    """Planted pairs of a gap's pieces (rows t, q, length) that the fill
    does not align."""
    want_q, want_t = _pairs(np.stack([pieces[:, 0], pieces[:, 0] + pieces[:, 2],
                                      pieces[:, 1], pieces[:, 1] + pieces[:, 2]],
                                     1))
    if not len(fill):
        return len(want_q)
    q, t = _pairs(fill)
    order = np.argsort(q, kind="stable")
    q, t = q[order], t[order]
    j = np.clip(np.searchsorted(q, want_q), 0, len(q) - 1)
    return int(((q[j] != want_q) | (t[j] != want_t)).sum())


def check(workload: dict, config: dict, outputs: list[str]) -> list:
    """[(name, value)] of the numbers compared; each limit is the
    traffic file's."""
    chain = workload["chains"][0]
    got = read_chains(outputs[0])
    if len(got) != 1:
        n = len(workload["pieces"])
        return [("gaps_unfilled", n), ("pairs_off_homolog", 0),
                ("fill_block_deficit_max", 0),
                ("fills_below_threshold", 0), ("blocks_misplaced", 1),
                ("homolog_missed_pct", 100.0)]
    misplaced, fills = _fills(chain, got[0])
    filled = [f for f in fills if len(f)]
    off = sum(_off_homolog(f, p) for f, p in zip(fills, workload["pieces"])
              if len(f))
    sc = scorer(workload, config)
    scores = sc.scores([dict(chain, blocks=f) for f in filled]) \
        if filled else []
    below = int(sum(1 for s in scores if s < config["score_threshold"]))
    deficit = 0.0
    if filled:
        blocks = np.concatenate(filled)
        long = blocks[blocks[:, 1] - blocks[:, 0] >= LONG_BLOCK]
        if len(long):
            deficit = max(0.0, -float(sc.block_sums(long, "+").min()))
    planted = int(sum(int(p[:, 2].sum()) for p in workload["pieces"]))
    missed = sum(_missed(f, p) for f, p in zip(fills, workload["pieces"]))
    return [("gaps_unfilled", len(fills) - len(filled)),
            ("pairs_off_homolog", off),
            ("fill_block_deficit_max", deficit),
            ("fills_below_threshold", below),
            ("blocks_misplaced", misplaced),
            ("homolog_missed_pct", 100.0 * missed / planted)]


def control(workload: dict, config: dict, out_dir: str, dtype) -> list[str]:
    """Each gap filled without its indels: one ungapped block from the
    first planted piece to the query end of the last, on the first piece's
    diagonal (the fill that an extension without the banded gapped stage
    would make).  dtype is not used: the guarantee broken is the gapped
    alignment, not a precision."""
    chain = workload["chains"][0]
    rows = [chain["blocks"][0]]
    for k, p in enumerate(workload["pieces"]):
        length = int(p[-1, 1] + p[-1, 2] - p[0, 1])
        rows.append(np.array([p[0, 0], p[0, 0] + length, p[0, 1],
                              p[0, 1] + length]))
        rows.append(chain["blocks"][k + 1])
    path = os.path.join(out_dir, "control.chain")
    write_chains(path, [dict(chain, blocks=np.array(rows, np.int64))])
    return [path]


def faults(workload: dict, out_dir: str, outputs: list[str]) -> dict:
    """{name: outputs} of the faults planted in the program's output and
    read beside the control: `truncated`, each fill cut after the gap's
    first planted piece, as an extension that stops at the first indel
    would leave it."""
    c = read_chains(outputs[0])[0]
    b = c["blocks"]
    anchors = workload["chains"][0]["blocks"]
    is_anchor = np.isin(b[:, 0], anchors[:, 0]) & np.isin(b[:, 2],
                                                           anchors[:, 2])
    first_end = np.array([p[0, 1] + p[0, 2] for p in workload["pieces"]])
    k = np.searchsorted(anchors[:, 3], b[:, 2], "right") - 1
    k = np.clip(k, 0, len(first_end) - 1)
    keep = is_anchor | (b[:, 2] < first_end[k])
    path = os.path.join(out_dir, "truncated.chain")
    write_chains(path, [dict(c, blocks=b[keep])])
    return {"truncated": [path]}
