"""The segmented combine of pair-mode rescoring: K2, its wrapper, its plain
version and the per-chain finish.

Counterpart of genomealignmenttools_tpu/ops/pallas_combine.py.  Per chunk,
three dependent segmented scans that restart at every chain start (F_START):

    c       = running sum of (s - bias)
    m       = min(F_SAMPLE ? c : I32_MAX, F_FIRST ? c - s : I32_MAX)
    runmin  = running min of m
    sampled = F_SAMPLE ? c - min(runmin, 0) : I32_MIN
    w       = running max of sampled

and per chain global = c[end], local = max(w[end], 0) (pallas_combine.py:
18-28), all int32.  `pair_combine_scan` launches K2 (csrc/combine.cu) on
CUDA tensors and runs `pair_combine_scan_plain` on CPU tensors.  The plain
version has the kernel's structure, with the tile size as a parameter: a
scan within each tile, a scan of the tile aggregates, and the carry of the
tiles before composed into each tile.  Integer scans are associative, so
every tile size gives the same bits; the CPU tests hold tiny tiles against
the JAX kernel's 32768-chunk tiles to exercise the carry composition.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import LAUNCHES, PERF

# flag bits, as PairChainScorer._meta packs them (pallas_combine.py:53-55)
F_START = 1     # first chunk of a chain
F_FIRST = 2     # first chunk of a block (its bias is the gap cost before it)
F_SAMPLE = 4    # last chunk of a block (a scored prefix)

I32_MAX = 2 ** 31 - 1
I32_MIN = -(2 ** 31) + 1   # not INT32_MIN: the sentinel of pallas_combine.py:50

TILE = 1024     # chunks per tile of the CUDA kernel (csrc/combine.cu kTile)


def _check_args(s, bias, flags) -> None:
    dev = s.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no combine path for device {dev}")
    for name, x in (("s", s), ("bias", bias), ("flags", flags)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, s on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if not (s.numel() == bias.numel() == flags.numel()):
        raise ValueError("s, bias and flags differ in length")


def _seg_scan_rows(v, f, op, identity):
    """Segmented inclusive scan along dim 1 of (rows, n) values `v` with
    reset flags `f` (bool), Hillis-Steele as in _seg_scan (pallas_combine.py:
    75-97).  Returns (scan, any reset at or before each position).  The
    shifted flags fill with False: the values fill with the identity, so
    combining past the row start is a no-op (the fill-0 fix of
    pallas_combine.py:82-88)."""
    rows, n = v.shape
    k = 1
    while k < n:
        sv = torch.cat([torch.full((rows, k), identity, dtype=v.dtype,
                                   device=v.device), v[:, :-k]], dim=1)
        sf = torch.cat([torch.zeros((rows, k), dtype=torch.bool,
                                    device=f.device), f[:, :-k]], dim=1)
        v = torch.where(f, v, op(sv, v))
        f = f | sf
        k *= 2
    return v, f


def _seg_scan_tiles(v, f, op, identity, tile: int):
    """Segmented inclusive scan of (M,) int32 `v` with reset flags `f`, in
    tiles of `tile`, as K2 runs it: each tile scanned alone, the tile
    aggregates scanned, and each tile's carry (the prefix of the tiles before
    it) composed into the positions before the tile's first reset."""
    m = v.numel()
    if m == 0:
        return v.clone()
    n_tiles = -(-m // tile)
    pad = n_tiles * tile - m
    if pad:
        v = torch.cat([v, torch.full((pad,), identity, dtype=v.dtype,
                                     device=v.device)])
        f = torch.cat([f, torch.zeros(pad, dtype=torch.bool,
                                      device=f.device)])
    v, f = _seg_scan_rows(v.view(n_tiles, tile), f.view(n_tiles, tile), op,
                          identity)
    incl, _ = _seg_scan_rows(v[:, -1].reshape(1, -1),
                             f[:, -1].reshape(1, -1), op, identity)
    carry = torch.cat([torch.full((1,), identity, dtype=v.dtype,
                                  device=v.device), incl[0, :-1]])
    return torch.where(f, v, op(carry[:, None], v)).reshape(-1)[:m]


def pair_combine_scan_plain(s, bias, flags, tile: int = TILE):
    """(c, w) int32 per chunk in plain PyTorch, tiled like the kernel."""
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    start = (flags & F_START) != 0
    first = (flags & F_FIRST) != 0
    sample = (flags & F_SAMPLE) != 0
    c = _seg_scan_tiles(s - bias, start, torch.add, 0, tile)
    m = torch.minimum(torch.where(sample, c, I32_MAX),
                      torch.where(first, c - s, I32_MAX))
    runmin = _seg_scan_tiles(m, start, torch.minimum, I32_MAX, tile)
    sampled = torch.where(sample, c - torch.clamp(runmin, max=0), I32_MIN)
    w = _seg_scan_tiles(sampled, start, torch.maximum, I32_MIN, tile)
    return c, w


def _launch_kernel(s, bias, flags):
    """Launch K2 on the current stream of the tensors' CUDA device."""
    lib = _build.load_library()
    dev = s.device
    m = s.numel()
    c = torch.empty(m, dtype=torch.int32, device=dev)
    w = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return c, w
    scratch = torch.empty(lib.gat_pair_combine_scratch(m), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gat_pair_combine(
            s.data_ptr(), bias.data_ptr(), flags.data_ptr(), m, c.data_ptr(),
            w.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("pair_combine launch failed: "
                           + lib.gat_cuda_error_string(err).decode())
    LAUNCHES["pair_combine"] += 1
    return c, w


def pair_combine_scan(s, bias, flags):
    """(c, w) int32 per chunk from int32 (M,) chunk sums, gap biases and
    flags, any M.  On CUDA tensors this launches K2 (csrc/combine.cu) or
    raises; on CPU tensors it runs the plain version."""
    _check_args(s, bias, flags)
    PERF["dispatches"] += 1
    if s.device.type == "cuda":
        return _launch_kernel(s, bias, flags)
    return pair_combine_scan_plain(s, bias, flags)


def pair_combine_finish(c, w, end_idx):
    """(n_chains, 2) int32 [global, local] from the per-chunk scans at each
    chain's last chunk `end_idx` (pallas_combine.py:179-184)."""
    return torch.stack([c[end_idx], torch.clamp(w[end_idx], min=0)], dim=1)
