"""Piecewise-linear gap cost tables ("linearGap" files).

Behavioral reference: kent/src/lib/gapCalc.c (struct gapCalc, interpolate,
gapCalcRead, gapCalcCost).  The cost of a gap of dq query bases and dt target
bases is an *integer*: the C code computes interpolations in double and
truncates toward zero on return (C double->int conversion).  We reproduce
that truncation exactly; byte-parity of every downstream score depends on it.

Three cost curves exist: q-only gaps, t-only gaps, and "both" gaps (dq>0 and
dt>0, keyed by dq+dt).  Gaps smaller than `small_size` use precomputed int
tables; mid-range gaps interpolate between log-spaced breakpoints; gaps past
the last breakpoint extrapolate with the final slope.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

# The two built-in cost tables.  Values match the built-in strings in the
# reference (gapCalc.c:40-56): "medium" is the original Evolution's Cauldron
# mouse/human table, "loose" is the chicken/human table and the usual default.
_MEDIUM = {
    "tableSize": 11,
    "smallSize": 111,
    "position": [1, 2, 3, 11, 111, 2111, 12111, 32111, 72111, 152111, 252111],
    "qGap": [350, 425, 450, 600, 900, 2900, 22900, 57900, 117900, 217900, 317900],
    "tGap": [350, 425, 450, 600, 900, 2900, 22900, 57900, 117900, 217900, 317900],
    "bothGap": [750, 825, 850, 1000, 1300, 3300, 23300, 58300, 118300, 218300, 318300],
}

_LOOSE = {
    "tableSize": 11,
    "smallSize": 111,
    "position": [1, 2, 3, 11, 111, 2111, 12111, 32111, 72111, 152111, 252111],
    "qGap": [325, 360, 400, 450, 600, 1100, 3600, 7600, 15600, 31600, 56600],
    "tGap": [325, 360, 400, 450, 600, 1100, 3600, 7600, 15600, 31600, 56600],
    "bothGap": [625, 660, 700, 750, 900, 1400, 4000, 8000, 16000, 32000, 57000],
}


def _interpolate_int(x: int, s: list[int], v: list[float]) -> int:
    """Exact re-creation of gapCalc.c:interpolate (returns truncated int)."""
    n = len(s)
    for i in range(n):
        ss = s[i]
        if x == ss:
            return int(v[i])
        if x < ss:
            ds = ss - s[i - 1]
            dv = v[i] - v[i - 1]
            return int(v[i - 1] + dv * (x - s[i - 1]) / ds)
    ds = s[n - 1] - s[n - 2]
    dv = v[n - 1] - v[n - 2]
    return int(v[n - 2] + dv * (x - s[n - 2]) / ds)


@dataclass
class GapCalc:
    """Precomputed gap cost calculator (mirrors struct gapCalc)."""

    small_size: int
    q_small: np.ndarray  # int64[small_size]
    t_small: np.ndarray
    b_small: np.ndarray
    long_pos: np.ndarray  # int64[longCount] breakpoints (>= small_size)
    q_long: np.ndarray  # float64 values at breakpoints
    t_long: np.ndarray
    b_long: np.ndarray
    q_last_pos: int = field(init=False)
    q_last_val: float = field(init=False)
    q_last_slope: float = field(init=False)
    t_last_pos: int = field(init=False)
    t_last_val: float = field(init=False)
    t_last_slope: float = field(init=False)
    b_last_pos: int = field(init=False)
    b_last_val: float = field(init=False)
    b_last_slope: float = field(init=False)

    def __post_init__(self):
        lp = self.long_pos
        for side, vals in (("q", self.q_long), ("t", self.t_long), ("b", self.b_long)):
            last_pos = int(lp[-1])
            last_val = float(vals[-1])
            slope = (last_val - float(vals[-2])) / (last_pos - int(lp[-2]))
            setattr(self, f"{side}_last_pos", last_pos)
            setattr(self, f"{side}_last_val", last_val)
            setattr(self, f"{side}_last_slope", slope)

    # ---- scalar exact path ------------------------------------------------
    def cost(self, dq: int, dt: int) -> int:
        """gapCalcCost(gapCalc, dq, dt) - exact int semantics."""
        if dt < 0:
            dt = 0
        if dq < 0:
            dq = 0
        if dt == 0:
            return self._one_sided(dq, self.q_small, self.q_long,
                                   self.q_last_pos, self.q_last_val, self.q_last_slope)
        if dq == 0:
            return self._one_sided(dt, self.t_small, self.t_long,
                                   self.t_last_pos, self.t_last_val, self.t_last_slope)
        both = dq + dt
        return self._one_sided(both, self.b_small, self.b_long,
                               self.b_last_pos, self.b_last_val, self.b_last_slope)

    def _one_sided(self, d, small, longv, last_pos, last_val, last_slope) -> int:
        if d < self.small_size:
            return int(small[d])
        if d >= last_pos:
            return int(last_val + last_slope * (d - last_pos))
        return _interpolate_int(d, self.long_pos.tolist(), longv.tolist())

    # ---- vectorized exact path (numpy) ------------------------------------
    def cost_vec(self, dq: np.ndarray, dt: np.ndarray) -> np.ndarray:
        """Vectorized gapCalcCost over int arrays; returns int64 array.

        Reproduces the per-element truncation semantics exactly: each
        interpolation result is computed in float64 (like the C double) and
        truncated toward zero.
        """
        dq = np.maximum(np.asarray(dq, dtype=np.int64), 0)
        dt = np.maximum(np.asarray(dt, dtype=np.int64), 0)
        out = np.zeros(dq.shape, dtype=np.int64)

        sel_q = dt == 0
        sel_t = (~sel_q) & (dq == 0)
        sel_b = ~(sel_q | sel_t)
        for sel, d, small, longv, lp, lval, lslope in (
            (sel_q, dq, self.q_small, self.q_long, self.q_last_pos, self.q_last_val, self.q_last_slope),
            (sel_t, dt, self.t_small, self.t_long, self.t_last_pos, self.t_last_val, self.t_last_slope),
            (sel_b, dq + dt, self.b_small, self.b_long, self.b_last_pos, self.b_last_val, self.b_last_slope),
        ):
            if not sel.any():
                continue
            dd = d[sel]
            res = np.empty(dd.shape, dtype=np.int64)
            small_mask = dd < self.small_size
            res[small_mask] = small[dd[small_mask]]
            big_mask = dd >= lp
            # trunc() toward zero matches the C double->int conversion
            res[big_mask] = np.trunc(lval + lslope * (dd[big_mask] - lp)).astype(np.int64)
            mid_mask = ~(small_mask | big_mask)
            if mid_mask.any():
                res[mid_mask] = self._interp_vec(dd[mid_mask], longv)
            out[sel] = res
        return out

    def _interp_vec(self, x: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized interpolate() with exact C truncation.

        Only called for small_size <= x < last_pos, where x never equals the
        first breakpoint, so searchsorted-based bracketing is safe.
        """
        s = self.long_pos
        # index of first breakpoint >= x
        idx = np.searchsorted(s, x, side="left")
        exact = s[np.minimum(idx, len(s) - 1)] == x
        i = np.maximum(idx, 1)
        ds = (s[i] - s[i - 1]).astype(np.float64)
        dv = v[i] - v[i - 1]
        res = np.trunc(v[i - 1] + dv * (x - s[i - 1]) / ds).astype(np.int64)
        res[exact] = np.trunc(v[idx[exact]]).astype(np.int64)
        return res


def _build(spec: dict) -> GapCalc:
    table_size = spec["tableSize"]
    small_size = spec["smallSize"]
    pos = spec["position"]
    qv = [float(x) for x in spec["qGap"]]
    tv = [float(x) for x in spec["tGap"]]
    bv = [float(x) for x in spec["bothGap"]]
    if len(pos) != table_size:
        raise ValueError("position count != tableSize")

    q_small = np.zeros(small_size, dtype=np.int64)
    t_small = np.zeros(small_size, dtype=np.int64)
    b_small = np.zeros(small_size, dtype=np.int64)
    for i in range(1, small_size):
        q_small[i] = _interpolate_int(i, pos, qv)
        t_small[i] = _interpolate_int(i, pos, tv)
        b_small[i] = _interpolate_int(i, pos, bv)

    start_long = None
    for i in range(table_size):
        if small_size == pos[i]:
            start_long = i
            break
    if start_long is None:
        raise ValueError(f"No position {small_size} in gap cost table")

    return GapCalc(
        small_size=small_size,
        q_small=q_small,
        t_small=t_small,
        b_small=b_small,
        long_pos=np.array(pos[start_long:], dtype=np.int64),
        q_long=np.array(qv[start_long:], dtype=np.float64),
        t_long=np.array(tv[start_long:], dtype=np.float64),
        b_long=np.array(bv[start_long:], dtype=np.float64),
    )


def _parse_gap_file_text(text: str) -> dict:
    """Parse a linearGap file (gapCalcRead format)."""
    lines = [ln for ln in text.splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    spec = {}
    expect = ["tableSize", "smallSize", "position", "qGap", "tGap", "bothGap"]
    idx = 0
    for tag in expect:
        words = lines[idx].split()
        if words[0].lower() != tag.lower():
            raise ValueError(f"Expecting {tag} got {words[0]}")
        nums = words[1:]
        if tag in ("tableSize", "smallSize"):
            spec[tag] = int(nums[0])
        elif tag == "position":
            spec[tag] = [int(x) for x in nums]
        else:
            spec[tag] = [float(x) for x in nums]
        idx += 1
    return spec


def gap_calc_from_file(name: str) -> GapCalc:
    """gapCalcFromFile: 'loose' | 'medium' | path to a linearGap file."""
    if name == "loose":
        return _build(_LOOSE)
    if name == "medium":
        return _build(_MEDIUM)
    with open(name) as f:
        return _build(_parse_gap_file_text(f.read()))


def gap_calc_default() -> GapCalc:
    return _build(_LOOSE)


def gap_calc_original() -> GapCalc:
    return _build(_MEDIUM)
