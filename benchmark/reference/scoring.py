"""Chain scores as kent's scoreChain defines them: the sum of the
substitution matrix over every aligned base, less the linear gap cost of
every gap between two blocks (kent src/lib/gapCalc.c, gapCalcCost).

Each score is an integer held in a double in the C tools; `dtype` is the
precision the sums and differences are taken in (float64 is exact here,
float32 is the control's)."""

from __future__ import annotations

import numpy as np

BATCH_BASES = 1 << 24
# the configuration's matrix is in A C G T order; codes are .2bit's T C A G
_ACGT_OF_CODE = np.array([3, 1, 0, 2])


def code_matrix(matrix_acgt) -> np.ndarray:
    """(16,) int64: the score of target code t against query code q at
    t * 4 + q."""
    m = np.asarray(matrix_acgt, np.int64)
    return m[np.ix_(_ACGT_OF_CODE, _ACGT_OF_CODE)].T.reshape(16)


class GapCost:
    """gapCalcCost of one linearGap table (the configuration's)."""

    def __init__(self, table: dict):
        pos = [int(p) for p in table["position"]]
        self.small_size = int(table["smallSize"])
        self.tables = {}
        for side in ("qGap", "tGap", "bothGap"):
            vals = [float(v) for v in table[side]]
            small = np.zeros(self.small_size, np.int64)
            for i in range(1, self.small_size):
                small[i] = self._interpolate(i, pos, vals)
            lo = next(i for i, p in enumerate(pos) if p >= self.small_size)
            lpos, lval = pos[lo:], vals[lo:]
            slope = (lval[-1] - lval[-2]) / (lpos[-1] - lpos[-2])
            self.tables[side] = (small, np.array(lpos, np.int64),
                                 np.array(lval), slope)

    @staticmethod
    def _interpolate(x, s, v) -> int:
        for i, ss in enumerate(s):
            if x == ss:
                return int(v[i])
            if x < ss:
                return int(v[i - 1] + (v[i] - v[i - 1]) * (x - s[i - 1])
                           / (ss - s[i - 1]))
        return int(v[-2] + (v[-1] - v[-2]) * (x - s[-2]) / (s[-1] - s[-2]))

    def _side(self, d: np.ndarray, side: str) -> np.ndarray:
        small, lpos, lval, slope = self.tables[side]
        out = np.empty(d.shape, np.int64)
        sm = d < self.small_size
        out[sm] = small[d[sm]]
        last = d >= lpos[-1]
        out[last] = np.trunc(lval[-1] + slope * (d[last] - lpos[-1]))
        mid = ~(sm | last)
        if mid.any():
            x = d[mid]
            i = np.searchsorted(lpos, x, "left")
            exact = lpos[i] == x
            s0, v0 = lpos[i - 1], lval[i - 1]
            val = np.trunc(v0 + ((lval[i] - v0) * (x - s0)) / (lpos[i] - s0))
            out[mid] = np.where(exact, lval[i], val)
        return out

    def cost(self, dq: np.ndarray, dt: np.ndarray) -> np.ndarray:
        dq = np.maximum(np.asarray(dq, np.int64), 0)
        dt = np.maximum(np.asarray(dt, np.int64), 0)
        out = np.empty(dq.shape, np.int64)
        only_q = dt == 0
        only_t = ~only_q & (dq == 0)
        both = ~(only_q | only_t)
        out[only_q] = self._side(dq[only_q], "qGap")
        out[only_t] = self._side(dt[only_t], "tGap")
        out[both] = self._side(dq[both] + dt[both], "bothGap")
        return out


class Scorer:
    """Global chain scores from the genome codes, in batches of blocks."""

    def __init__(self, t_codes, q_codes, matrix_acgt, gap_table,
                 dtype=np.float64):
        self.t_codes = t_codes
        self.q_codes = q_codes
        self._q_rc = None
        self.lut = code_matrix(matrix_acgt)
        self.gaps = GapCost(gap_table)
        self.dtype = dtype

    def q_side(self, strand: str) -> np.ndarray:
        if strand == "+":
            return self.q_codes
        if self._q_rc is None:
            self._q_rc = self.q_codes[::-1] ^ 2
        return self._q_rc

    def block_sums(self, blocks: np.ndarray, strand: str) -> np.ndarray:
        """(n,) sums of the matrix over each block, in self.dtype: one
        running sum over the batch, differenced at the block ends."""
        q = self.q_side(strand)
        out = np.empty(len(blocks), self.dtype)
        sizes = blocks[:, 1] - blocks[:, 0]
        ends = np.cumsum(sizes)
        lo = 0
        while lo < len(blocks):
            hi = max(lo + 1, int(np.searchsorted(
                ends, ends[lo] - sizes[lo] + BATCH_BASES, "right")))
            sz = sizes[lo:hi]
            first = np.cumsum(sz) - sz
            ar = np.arange(int(sz.sum()), dtype=np.int64)
            t = self.t_codes[np.repeat(blocks[lo:hi, 0] - first, sz) + ar]
            qq = q[np.repeat(blocks[lo:hi, 2] - first, sz) + ar]
            run = np.cumsum(self.lut[t.astype(np.int64) * 4 + qq]
                            .astype(self.dtype), dtype=self.dtype)
            at_end = run[np.cumsum(sz) - 1]
            out[lo:hi] = np.diff(at_end, prepend=self.dtype(0))
            lo = hi
        return out

    def scores(self, chains) -> np.ndarray:
        """(n,) float64 global scores of chains (dicts with `blocks` and
        `q_strand`)."""
        out = np.empty(len(chains), np.float64)
        for strand in ("+", "-"):
            idx = [i for i, c in enumerate(chains) if c["q_strand"] == strand]
            if not idx:
                continue
            blocks = [chains[i]["blocks"] for i in idx]
            nb = np.array([len(b) for b in blocks])
            allb = np.concatenate(blocks)
            sums = self.block_sums(allb, strand)
            first = np.cumsum(nb) - nb
            per_chain = np.add.reduceat(sums, first) if len(sums) else sums
            gap = np.ones(len(allb), bool)
            gap[first] = False               # no gap before a chain's first
            dt = allb[1:, 0] - allb[:-1, 1]
            dq = allb[1:, 2] - allb[:-1, 3]
            cost = np.zeros(len(allb), np.int64)
            cost[1:] = self.gaps.cost(dq, dt)
            cost[~gap] = 0
            gap_sum = np.add.reduceat(cost, first).astype(self.dtype)
            out[idx] = (per_chain.astype(self.dtype) - gap_sum).astype(
                np.float64)
        return out
