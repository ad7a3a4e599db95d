"""Connect costs, crossover repair, and block cleanup for chaining.

Behavioral reference: kent/src/lib/chainConnect.c (cBlockFindCrossover:
61-105, chainConnectCost:114-149, chainRemovePartialOverlaps:255-344,
chainMergeAbutting:346-368, removeNegativeBlocks/setChainBounds).

Blocks are represented as mutable python lists of [tS, tE, qS, qE, score]
rows during chaining; sequences are uint8 code arrays with an int LUT
(matrix[q][t] ~ lut[q_code, t_code]).
"""

from __future__ import annotations

import numpy as np

from ..formats.gapcalc import GapCalc

ENCLOSED_OVERLAP_PENALTY = 100000000


def score_block_codes(q_codes, t_codes, q_start, t_start, size, lut) -> int:
    """chainScoreBlock / axtScoreUngapped over code arrays."""
    if size <= 0:
        return 0
    qs = q_codes[q_start:q_start + size].astype(np.int64)
    ts = t_codes[t_start:t_start + size].astype(np.int64)
    return int(lut.astype(np.int64)[qs, ts].sum())


def find_crossover(left, right, q_codes, t_codes, overlap, lut):
    """cBlockFindCrossover: best split point of two overlapping blocks.

    Returns (crossover_pos, score_adjustment)."""
    lut64 = lut.astype(np.int64)
    rq, rt = right[2], right[0]
    lq, lt = left[3] - overlap, left[1] - overlap
    r_scores = lut64[q_codes[rq:rq + overlap].astype(np.int64),
                     t_codes[rt:rt + overlap].astype(np.int64)]
    l_scores = lut64[q_codes[lq:lq + overlap].astype(np.int64),
                     t_codes[lt:lt + overlap].astype(np.int64)]
    r_score = int(r_scores.sum())
    l_score = int(l_scores.sum())
    # running score starting from all-right, swapping prefix to left
    best_score = score = r_score
    best_pos = 0
    # prefix sums vectorized: score_i = r_score + cumsum(l - r)[i]
    if overlap:
        deltas = np.cumsum(l_scores - r_scores)
        scores = r_score + deltas
        best_idx = int(np.argmax(scores))  # first max (C keeps first strict >)
        if scores[best_idx] > best_score:
            best_score = int(scores[best_idx])
            best_pos = best_idx + 1
    return best_pos, r_score + l_score - best_score


def connect_cost(a, b, q_codes, t_codes, lut, gap_calc: GapCalc) -> int:
    """chainConnectCost between blocks a, b ([tS,tE,qS,qE,...])."""
    dq = b[2] - a[3]
    dt = b[0] - a[1]
    if a[2] >= b[2] or a[0] >= b[0]:
        raise ValueError(f"a ({a[2]} {a[0]}) not strictly before b ({b[2]} {b[0]})")
    overlap_adjustment = 0
    if dq < 0 or dt < 0:
        b_size = b[3] - b[2]
        a_size = a[3] - a[2]
        overlap = -min(dq, dt)
        if overlap >= b_size or overlap >= a_size:
            overlap_adjustment = ENCLOSED_OVERLAP_PENALTY
        else:
            _, overlap_adjustment = find_crossover(a, b, q_codes, t_codes,
                                                  overlap, lut)
            dq += overlap
            dt += overlap
    return overlap_adjustment + gap_calc.cost(dq, dt)


def gap_cost(dq, dt, gap_calc: GapCalc) -> int:
    """chainConnectGapCost."""
    return gap_calc.cost(dq, dt)


def remove_partial_overlaps(blocks: list, q_codes, t_codes, lut) -> list:
    """chainRemovePartialOverlaps over a sorted block list (mutates rows)."""

    def remove_negative(blks):
        return [b for b in blks if b[2] < b[3] and b[0] < b[1]]

    while True:
        total_trim_a = False
        i = 0
        while i + 1 < len(blocks):
            a = blocks[i]
            b = blocks[i + 1]
            dq = b[2] - a[3]
            dt = b[0] - a[1]
            total_trim_b = False
            if dq < 0 or dt < 0:
                overlap = -min(dq, dt)
                a_size = a[3] - a[2]
                b_size = b[3] - b[2]
                if overlap >= a_size or overlap >= b_size:
                    total_trim_b = True
                else:
                    crossover, _ = find_crossover(a, b, q_codes, t_codes,
                                                  overlap, lut)
                    b[2] += crossover
                    b[0] += crossover
                    inv_cross = overlap - crossover
                    a[3] -= inv_cross
                    a[1] -= inv_cross
                    if b[3] <= b[2]:
                        total_trim_b = True
                    elif a[3] <= a[2]:
                        total_trim_a = True
            if total_trim_a:
                blocks = remove_negative(blocks)
                break
            if total_trim_b:
                del blocks[i + 1]
            else:
                i += 1
        if not total_trim_a:
            break
    return blocks


def merge_abutting(blocks: list) -> list:
    """chainMergeAbutting."""
    out = []
    for b in blocks:
        if out and out[-1][3] == b[2] and out[-1][1] == b[0]:
            out[-1][3] = b[3]
            out[-1][1] = b[1]
        else:
            out.append(b)
    return out
