"""Exact chain scoring: global and local ("clamped") scores.

Behavioral reference: kent/src/lib/chainConnect.c (chainScoreBlock:14-22,
chainCalcScore:24-40) and src/scoreChain/scoreChain.c:chainCalcScoreLocal
(clamp-at-zero running score whose max is the local score; also counts
aligning bases).

All quantities are integers (matrix entries and gapCalcCost are ints; the C
double accumulator is exact for these magnitudes), so we compute in int64
and convert at the edges.  The local score's sequential clamp loop is
rewritten as the closed form
    S_j = C_j - min(0, min_{k<=j} C_k)
(clamped prefix sums equal raw prefix sums minus the running minimum),
which vectorizes on both host and device; see tests for equivalence with
the direct loop.

This module is the host (numpy) reference path; ops/rescore.py provides the
batched JAX/Pallas device path that must agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from ..formats.chain import Chain
from ..formats.gapcalc import GapCalc
from ..formats.scorematrix import ScoreScheme


def block_base_indices(blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat per-base (t_idx, q_idx) arrays + block offsets for reduceat."""
    sizes = blocks[:, 1] - blocks[:, 0]
    total = int(sizes.sum())
    offsets = np.zeros(len(sizes), dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    pos = np.arange(total, dtype=np.int64) - np.repeat(offsets, sizes)
    t_idx = np.repeat(blocks[:, 0], sizes) + pos
    q_idx = np.repeat(blocks[:, 2], sizes) + pos
    return t_idx, q_idx, offsets


def block_scores(blocks: np.ndarray, t_codes: np.ndarray, q_codes: np.ndarray,
                 lut: np.ndarray) -> np.ndarray:
    """Per-block sum of matrix[q[i]][t[i]] (chainScoreBlock), int64.

    blocks: (n,4) [tStart,tEnd,qStart,qEnd] in the coordinate frames of
    t_codes / q_codes ('-' strand q handled by passing the revcomp array).
    """
    if blocks.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    t_idx, q_idx, offsets = block_base_indices(blocks)
    flat = lut.astype(np.int64).ravel()
    ncodes = lut.shape[0]
    per_base = flat[q_codes[q_idx].astype(np.int64) * ncodes + t_codes[t_idx]]
    return np.add.reduceat(per_base, offsets)


def gap_costs(blocks: np.ndarray, gap_calc: GapCalc) -> np.ndarray:
    """Per-gap gapCalcCost between consecutive blocks, int64 length n-1."""
    if blocks.shape[0] <= 1:
        return np.zeros(0, dtype=np.int64)
    dt = blocks[1:, 0] - blocks[:-1, 1]
    dq = blocks[1:, 2] - blocks[:-1, 3]
    return gap_calc.cost_vec(dq, dt)


def chain_global_score(bs: np.ndarray, gc: np.ndarray) -> int:
    """chainCalcScore: sum(block scores) - sum(gap costs)."""
    return int(bs.sum() - gc.sum())


def chain_local_score(bs: np.ndarray, gc: np.ndarray) -> int:
    """chainCalcScoreLocal's max-of-clamped-running-score, exact.

    Interleave [bs0, -g0, bs1, -g1, ..., bs_{n-1}]; the clamped running sum
    after step j is C_j - min(0, min_{k<=j} C_k).  The local score is the max
    of the values at block steps (even indices), floored at 0.
    """
    n = len(bs)
    if n == 0:
        return 0
    d = np.empty(2 * n - 1, dtype=np.int64)
    d[0::2] = bs
    if n > 1:
        d[1::2] = -gc
    c = np.cumsum(d)
    runmin = np.minimum(np.minimum.accumulate(c), 0)
    clamped = c - runmin
    return max(0, int(clamped[0::2].max()))


class ChainScorer:
    """Scores chains against target/query genomes (host exact path)."""

    def __init__(self, scheme: ScoreScheme, gap_calc: GapCalc,
                 t_genome, q_genome):
        self.scheme = scheme
        self.gap_calc = gap_calc
        self.t_genome = t_genome
        self.q_genome = q_genome

    def score_arrays(self, chain: Chain) -> tuple[np.ndarray, np.ndarray]:
        """(block_scores, gap_costs) for a chain."""
        t_codes = self.t_genome.codes(chain.t_name, "+")
        q_codes = self.q_genome.codes(chain.q_name, chain.q_strand)
        bs = block_scores(chain.blocks, t_codes, q_codes, self.scheme.lut)
        gc = gap_costs(chain.blocks, self.gap_calc)
        return bs, gc

    def global_score(self, chain: Chain) -> float:
        bs, gc = self.score_arrays(chain)
        return float(chain_global_score(bs, gc))

    def global_and_local(self, chain: Chain) -> tuple[float, float, int]:
        """(globalScore, localScore, aliBases) - scoreChain's getChainScore."""
        bs, gc = self.score_arrays(chain)
        g = chain_global_score(bs, gc)
        l = chain_local_score(bs, gc)
        ali = int((chain.blocks[:, 1] - chain.blocks[:, 0]).sum())
        return float(g), float(l), ali
