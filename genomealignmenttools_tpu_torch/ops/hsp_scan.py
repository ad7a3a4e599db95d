"""The best ungapped segment score of every HSP scan window: K4, its wrapper
and its plain version.

The gap aligner (ops/seed_extend.py) scans each seed window of a gap for
maximal-scoring segments of at least K.  Its filter pass, a Kadane pass per
window giving the window's best segment score, is the whole of the scan's
work but for the few windows that reach K.  `hsp_best` computes it for
every window of a chunk of gaps at once: on CUDA tensors it launches K4
(csrc/hspscan.cu), on CPU tensors it runs `hsp_best_plain`; both return the
same int32 per window:

    best[w] = max over non-empty segments [a, b) of the window of
              sum_{a <= i < b} lut[q[q_start[w] + i], t[t_start[w] + i]]

over uint8 codes (T=0 C=1 A=2 G=3 N=4), int64 window starts and int32
lengths of at least one cell.  It is the `best` of native/hspscan.cpp's
filter pass, which may be negative.  K4 sums in int32, so a window may hold
at most MAX_WINDOW cells and its length times the largest |lut| must stay
under 2^28; the wrapper raises otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..device import LAUNCHES, PERF

MAX_WINDOW = 1_000_000     # cells of a window: the aligner's max_region
SUM_LIMIT = 1 << 28        # bound on |sum| of a window (K4's int32 state)
PLAIN_CELLS = 1 << 22      # cells the plain version expands at a time


def _check_args(t_codes, q_codes, lut, t_start, q_start, length) -> None:
    """Raise on anything K4 does not take: device, dtype, shape,
    contiguity, codes above 4, window lengths and window bounds."""
    dev = t_codes.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no HSP scan path for device {dev}")
    for name, x, dtype in (("t_codes", t_codes, torch.uint8),
                           ("q_codes", q_codes, torch.uint8),
                           ("t_start", t_start, torch.int64),
                           ("q_start", q_start, torch.int64),
                           ("length", length, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t_codes on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if not (t_start.numel() == q_start.numel() == length.numel()):
        raise ValueError("t_start, q_start and length differ in length")
    if lut.device.type != "cpu" or lut.dtype != torch.int32 \
            or tuple(lut.shape) != (5, 5):
        raise ValueError("lut must be a (5, 5) int32 tensor on the CPU")
    if length.numel() == 0:
        return
    for name, codes in (("t_codes", t_codes), ("q_codes", q_codes)):
        if codes.numel() and int(codes.max()) > 4:
            raise ValueError(f"{name} must be 0..4")
    ln = length.to(torch.int64)
    bad = ((length < 1) | (t_start < 0) | (q_start < 0)
           | (t_start + ln > t_codes.numel())
           | (q_start + ln > q_codes.numel()))
    if bool(bad.any()):
        raise IndexError("a window is empty or lies outside its code array")
    longest = int(length.max())
    if longest > MAX_WINDOW or longest * int(lut.abs().max()) >= SUM_LIMIT:
        raise ValueError(f"a window of {longest} cells is too long for K4's "
                         f"int32 sums (at most {MAX_WINDOW} cells and "
                         f"cells * max|lut| < 2^28)")


def hsp_best_plain(t_codes, q_codes, lut, t_start, q_start, length):
    """int32 best segment score per window in plain PyTorch on the tensors'
    own device: the grouped Kadane of GapAligner._scan_windows, over
    PLAIN_CELLS cells at a time.  Each window's cells are gathered from both
    code arrays, their prefix sums taken per window, and a segmented running
    minimum (windows kept apart by an offset of `big` per window) gives the
    least prefix before each cell."""
    dev = t_codes.device
    n = length.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    table = lut.to(device=dev, dtype=torch.int64).reshape(-1)
    ln = length.to(torch.int64)
    ends = torch.cumsum(ln, 0)
    big = 4 * SUM_LIMIT        # keeps each window's running minimum its own
    lo = 0
    while lo < n:
        # windows lo .. hi-1: at least one, at most PLAIN_CELLS cells beyond
        # the first
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(torch.searchsorted(ends, base + PLAIN_CELLS,
                                                right=True)))
        hi = min(hi, n)
        wl = ln[lo:hi]
        total = int(wl.sum())
        win = torch.repeat_interleave(torch.arange(hi - lo, device=dev), wl,
                                      output_size=total)
        first = torch.cumsum(wl, 0) - wl
        pos = torch.arange(total, device=dev) - first[win]
        tc = t_codes[t_start[lo:hi][win] + pos].to(torch.int64)
        qc = q_codes[q_start[lo:hi][win] + pos].to(torch.int64)
        v = table[qc * 5 + tc]
        c = torch.cumsum(v, 0)
        pref = c - (c[first] - v[first])[win]   # window prefix through cell
        lead = pref - v                         # prefix before the cell
        off = win * big
        least = torch.cummin(lead - off, 0).values + off
        best = torch.full((hi - lo,), -SUM_LIMIT, dtype=torch.int64,
                          device=dev)
        best.scatter_reduce_(0, win, pref - least, "amax")
        out[lo:hi] = best.to(torch.int32)
        lo = hi
    return out


def _launch_kernel(t_codes, q_codes, lut, t_start, q_start, length):
    """Launch K4 on the current stream of the tensors' CUDA device."""
    lib = _build.load_library()
    dev = t_codes.device
    n = length.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lut25 = (ctypes.c_int32 * 25)(*lut.reshape(-1).tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gat_hsp_best(
            t_codes.data_ptr(), q_codes.data_ptr(), lut25,
            t_start.data_ptr(), q_start.data_ptr(), length.data_ptr(), n,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("hsp_best launch failed: "
                           + lib.gat_cuda_error_string(err).decode())
    LAUNCHES["hsp_best"] += 1
    return out


def hsp_best(t_codes, q_codes, lut, t_start, q_start, length):
    """Each window's best segment score (int32).  On CUDA tensors this
    launches K4 (csrc/hspscan.cu) or raises; on CPU tensors it runs the
    plain version.  All tensors are 1-D and contiguous on one device: uint8
    codes, int64 window starts, int32 lengths; `lut` is a (5, 5) int32 CPU
    tensor indexed [q, t]."""
    _check_args(t_codes, q_codes, lut, t_start, q_start, length)
    PERF["dispatches"] += 1
    fn = _launch_kernel if t_codes.device.type == "cuda" else hsp_best_plain
    return fn(t_codes, q_codes, lut, t_start, q_start, length)
