"""The segmented combine of pair-mode rescoring: K2, its wrappers, its plain
versions and the per-chain finish.

Counterpart of genomealignmenttools_tpu/ops/pallas_combine.py, with the row
sum of the reference's fused pass (pair_rescore.py::_fused_pass, :748-761).
Per chunk, three dependent segmented scans that restart at every chain start
(F_START):

    c       = running sum of (s - bias)
    m       = min(F_SAMPLE ? c : I32_MAX, F_FIRST ? c - s : I32_MAX)
    runmin  = running min of m
    sampled = F_SAMPLE ? c - min(runmin, 0) : I32_MIN
    w       = running max of sampled

and per chain global = c[end], local = max(w[end], 0) (pallas_combine.py:
18-28), all int32.  K2 (csrc/combine.cu) takes s from one of two sources:
`pair_combine_scan_tiles` sums each row of the (M, chunk) int8 score tiles
(plus an optional int32 tweak) inside the kernel, in the same launch as the
scans: the resident pass; `pair_combine_scan` takes int32 s.  Each launches
K2 on CUDA tensors and runs its plain version on CPU tensors.  The plain
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

TILE = 2048     # chunks per tile of the CUDA kernel (csrc/combine.cu kTile)
CHUNK_MIN, CHUNK_MAX = 2, 258   # even tile widths K2 takes (258 * 127 < 2^15)


def _check_args(s, bias, flags, first: str = "s") -> None:
    dev = s.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no combine path for device {dev}")
    for name, x in ((first, s), ("bias", bias), ("flags", flags)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {first} on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if not (s.numel() == bias.numel() == flags.numel()):
        raise ValueError(f"{first}, bias and flags differ in length")


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


def _check_tiles(tiles, bias, flags, tweak) -> None:
    _check_args(bias, bias, flags, first="bias")
    if tiles.device != bias.device:
        raise ValueError(f"tiles are on {tiles.device}, bias on {bias.device}")
    if tiles.dtype != torch.int8:
        raise TypeError(f"tiles must be torch.int8, got {tiles.dtype}")
    if tiles.dim() != 2 or not tiles.is_contiguous():
        raise ValueError("tiles must be a contiguous 2-D tensor")
    if tiles.shape[0] != bias.numel():
        raise ValueError(f"tiles have {tiles.shape[0]} rows, bias "
                         f"{bias.numel()} chunks")
    chunk = tiles.shape[1]
    if not CHUNK_MIN <= chunk <= CHUNK_MAX or chunk % 2:
        raise ValueError(f"tile width {chunk}: must be even and between "
                         f"{CHUNK_MIN} and {CHUNK_MAX}")
    if tiles.data_ptr() % 16:
        raise ValueError("tiles must start on a 16-byte boundary (K2 reads "
                         "rows 16 bytes at a time)")
    if tweak is not None:
        if tweak.device != bias.device:
            raise ValueError(f"tweak is on {tweak.device}, bias on "
                             f"{bias.device}")
        if tweak.dtype != torch.int32 or tweak.numel() != 1:
            raise TypeError("tweak must be one torch.int32 value")


def pair_combine_scan_tiles_plain(tiles, bias, flags, tweak=None,
                                  tile: int = TILE):
    """(c, w) int32 per chunk in plain PyTorch: the int32 row sums of the
    int8 tiles, plus the tweak, through pair_combine_scan_plain."""
    s = tiles.sum(dim=1, dtype=torch.int32)
    if tweak is not None:
        s = s + tweak.reshape(())
    return pair_combine_scan_plain(s, bias, flags, tile)


def _launch(entry, m: int, dev, *args):
    """Launch one of K2's entries on the current stream of `dev`: m int32
    outputs c and w, and the zeroed scratch the kernel's look-back needs."""
    lib = _build.load_library()
    c = torch.empty(m, dtype=torch.int32, device=dev)
    w = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return c, w
    scratch = torch.zeros(lib.gat_pair_combine_scratch(m), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*args, m, c.data_ptr(), w.data_ptr(),
                                  scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.gat_cuda_error_string(err).decode())
    LAUNCHES["pair_combine"] += 1
    return c, w


def _launch_kernel(s, bias, flags):
    """K2 from int32 chunk sums, on the tensors' CUDA device."""
    return _launch("gat_pair_combine", s.numel(), s.device, s.data_ptr(),
                   bias.data_ptr(), flags.data_ptr())


def _launch_tiles(tiles, bias, flags, tweak=None):
    """K2 from int8 score tiles, on the tensors' CUDA device."""
    return _launch("gat_pair_combine_tiles", bias.numel(), bias.device,
                   tiles.data_ptr(), tiles.shape[1],
                   None if tweak is None else tweak.data_ptr(),
                   bias.data_ptr(), flags.data_ptr())


def pair_combine_scan(s, bias, flags):
    """(c, w) int32 per chunk from int32 (M,) chunk sums, gap biases and
    flags, any M.  On CUDA tensors this launches K2 (csrc/combine.cu) or
    raises; on CPU tensors it runs the plain version."""
    _check_args(s, bias, flags)
    PERF["dispatches"] += 1
    if s.device.type == "cuda":
        return _launch_kernel(s, bias, flags)
    return pair_combine_scan_plain(s, bias, flags)


def pair_combine_scan_tiles(tiles, bias, flags, tweak=None):
    """(c, w) int32 per chunk from (M, chunk) int8 score tiles (s = each
    row's int32 sum, plus `tweak`, one int32 value on the same device, if
    given), gap biases and flags, any M.  On CUDA tensors this launches K2
    (csrc/combine.cu), which reads every tile byte once and scans in the
    same launch, or raises; on CPU tensors it runs the plain version."""
    _check_tiles(tiles, bias, flags, tweak)
    PERF["dispatches"] += 1
    if bias.device.type == "cuda":
        return _launch_tiles(tiles, bias, flags, tweak)
    return pair_combine_scan_tiles_plain(tiles, bias, flags, tweak)


def pair_combine_finish(c, w, end_idx):
    """(n_chains, 2) int32 [global, local] from the per-chunk scans at each
    chain's last chunk `end_idx` (pallas_combine.py:179-184)."""
    return torch.stack([c[end_idx], torch.clamp(w[end_idx], min=0)], dim=1)
