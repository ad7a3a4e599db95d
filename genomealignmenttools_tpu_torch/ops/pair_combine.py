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
18-28), all int32.  K2 (csrc/combine.cu) takes s from one of four sources:
`pair_combine_scan` takes int32 s; `pair_combine_scan_tiles` makes s inside
the kernel, in the same launch as the scans, as the int32 sum of each row of
(M, width) tiles plus an optional int32 tweak, in one of the three tile
formats of the reference's PairBlockScorer (pair_rescore.py:345-371):

    kind      tiles                                table
    score8    int8 scores, a byte a base            none
    code      uint8 q * 5 + t, a byte a base        int8[25] scores
    score4    uint8, two 4-bit indices a byte       int8[16] values

A code byte scores table[c] where q and t are both below 4 and 0 otherwise
(N rows and columns, the pad 24, any byte of 25 or more), as _pair_vals
(pair_rescore.py:80-92) decodes it; a score4 byte scores table[b & 15] +
table[b >> 4] (_score4_vals, :143-155).  Each wrapper launches K2 on CUDA
tensors and runs its plain version on CPU tensors; LAUNCHES counts each row
source under its own key.  The plain version has the kernel's structure,
with the tile size as a parameter: a scan within each tile, a scan of the
tile aggregates, and the carry of the tiles before composed into each tile.
Integer scans are associative, so every tile size gives the same bits; the
CPU tests hold tiny tiles against the JAX kernel's 32768-chunk tiles to
exercise the carry composition.
"""

from __future__ import annotations

import ctypes

import numpy as np
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

# tile formats: K2's row sources, their tile dtype, the length of the table
# they take, their C entry and their LAUNCHES key
KINDS = ("score8", "code", "score4")
_DTYPE = {"score8": torch.int8, "code": torch.uint8, "score4": torch.uint8}
_TABLE_LEN = {"score8": None, "code": 25, "score4": 16}
_ENTRY = {"score8": "gat_pair_combine_tiles", "code": "gat_pair_combine_code",
          "score4": "gat_pair_combine_score4"}
LAUNCH_KEY = {"score8": "pair_combine", "code": "pair_combine_code",
              "score4": "pair_combine_score4"}
_ROWS_AT_ONCE = 1 << 16   # rows the plain decoders index at a time


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


def _check_widths(kind: str, width: int) -> None:
    if kind == "score4":
        if not 1 <= width <= CHUNK_MAX // 2:
            raise ValueError(f"score4 tile width {width}: must be between 1 "
                             f"and {CHUNK_MAX // 2} bytes")
    elif not CHUNK_MIN <= width <= CHUNK_MAX or width % 2:
        raise ValueError(f"tile width {width}: must be even and between "
                         f"{CHUNK_MIN} and {CHUNK_MAX}")


def _check_tiles(tiles, bias, flags, tweak, kind="score8", table=None):
    if kind not in KINDS:
        raise ValueError(f"tile kind {kind!r}: use one of {', '.join(KINDS)}")
    _check_args(bias, bias, flags, first="bias")
    if tiles.device != bias.device:
        raise ValueError(f"tiles are on {tiles.device}, bias on {bias.device}")
    if tiles.dtype != _DTYPE[kind]:
        raise TypeError(f"{kind} tiles must be {_DTYPE[kind]}, got "
                        f"{tiles.dtype}")
    if tiles.dim() != 2 or not tiles.is_contiguous():
        raise ValueError("tiles must be a contiguous 2-D tensor")
    if tiles.shape[0] != bias.numel():
        raise ValueError(f"tiles have {tiles.shape[0]} rows, bias "
                         f"{bias.numel()} chunks")
    _check_widths(kind, tiles.shape[1])
    if tiles.data_ptr() % 16:
        raise ValueError("tiles must start on a 16-byte boundary (K2 reads "
                         "rows 16 bytes at a time)")
    n = _TABLE_LEN[kind]
    if n is None:
        if table is not None:
            raise ValueError("score8 tiles take no table")
    elif (not isinstance(table, torch.Tensor) or table.device.type != "cpu"
          or table.dtype != torch.int8 or table.shape != (n,)):
        raise TypeError(f"{kind} tiles need a table of {n} torch.int8 "
                        f"values on the CPU")
    if tweak is not None:
        if tweak.device != bias.device:
            raise ValueError(f"tweak is on {tweak.device}, bias on "
                             f"{bias.device}")
        if tweak.dtype != torch.int32 or tweak.numel() != 1:
            raise TypeError("tweak must be one torch.int32 value")


def code_table(lut25) -> torch.Tensor:
    """int32[256] score of every byte as a combined code: lut25[c] where
    q = c // 5 and t = c % 5 are both below 4, 0 for every other byte."""
    c = torch.arange(256)
    live = (c < 25) & (c // 5 < 4) & (c % 5 < 4)
    out = torch.zeros(256, dtype=torch.int32)
    out[live] = torch.as_tensor(lut25).to(torch.int32).reshape(-1)[c[live]]
    return out


def tile_row_sums(tiles, kind: str = "score8", table=None) -> torch.Tensor:
    """(M,) int32 row sums of (M, width) tiles of the format `kind`, decoded
    with torch ops on the tiles' device: the counterparts of the XLA jits
    _chunk_sums_i32_scored, _chunk_sums_i32 and _chunk_sums_i32_scored4
    (pair_rescore.py:131-134, 600-603, 164-167)."""
    if kind == "score8":
        return tiles.sum(dim=1, dtype=torch.int32)
    if kind == "code":
        values = code_table(table).to(tiles.device)
    elif kind == "score4":
        values = torch.as_tensor(table).to(torch.int32).to(tiles.device)
    else:
        raise ValueError(f"tile kind {kind!r}: use one of {', '.join(KINDS)}")
    out = torch.empty(tiles.shape[0], dtype=torch.int32, device=tiles.device)
    for lo in range(0, tiles.shape[0], _ROWS_AT_ONCE):
        part = tiles[lo:lo + _ROWS_AT_ONCE].to(torch.int64)
        if kind == "code":
            out[lo:lo + _ROWS_AT_ONCE] = values[part].sum(dim=1,
                                                           dtype=torch.int32)
        else:
            out[lo:lo + _ROWS_AT_ONCE] = (
                values[part & 15].sum(dim=1, dtype=torch.int32)
                + values[part >> 4].sum(dim=1, dtype=torch.int32))
    return out


def pair_combine_scan_tiles_plain(tiles, bias, flags, tweak=None,
                                  kind: str = "score8", table=None,
                                  tile: int = TILE):
    """(c, w) int32 per chunk in plain PyTorch: the int32 row sums of the
    tiles (tile_row_sums), plus the tweak, through pair_combine_scan_plain."""
    s = tile_row_sums(tiles, kind, table)
    if tweak is not None:
        s = s + tweak.reshape(())
    return pair_combine_scan_plain(s, bias, flags, tile)


def _launch(entry, key: str, m: int, dev, *args):
    """Launch one of K2's entries on the current stream of `dev`: m int32
    outputs c and w, and the zeroed scratch the kernel's look-back needs;
    counts the launch under LAUNCHES[key]."""
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
    LAUNCHES[key] += 1
    return c, w


def _launch_kernel(s, bias, flags):
    """K2 from int32 chunk sums, on the tensors' CUDA device."""
    return _launch("gat_pair_combine", "pair_combine", s.numel(), s.device,
                   s.data_ptr(), bias.data_ptr(), flags.data_ptr())


def _launch_tiles(tiles, bias, flags, tweak=None, kind: str = "score8",
                  table=None):
    """K2 from tiles of the format `kind`, on the tensors' CUDA device."""
    tw = None if tweak is None else tweak.data_ptr()
    args = [tiles.data_ptr(), tiles.shape[1]]
    if kind != "score8":
        host = np.ascontiguousarray(table.numpy(), np.int8)
        args.append(host.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return _launch(_ENTRY[kind], LAUNCH_KEY[kind], bias.numel(), bias.device,
                   *args, tw, bias.data_ptr(), flags.data_ptr())


def pair_combine_scan(s, bias, flags):
    """(c, w) int32 per chunk from int32 (M,) chunk sums, gap biases and
    flags, any M.  On CUDA tensors this launches K2 (csrc/combine.cu) or
    raises; on CPU tensors it runs the plain version."""
    _check_args(s, bias, flags)
    PERF["dispatches"] += 1
    if s.device.type == "cuda":
        return _launch_kernel(s, bias, flags)
    return pair_combine_scan_plain(s, bias, flags)


def pair_combine_scan_tiles(tiles, bias, flags, tweak=None,
                            kind: str = "score8", table=None):
    """(c, w) int32 per chunk from (M, width) tiles of the format `kind`
    (s = each row's int32 sum, plus `tweak`, one int32 value on the same
    device, if given), gap biases and flags, any M.  `table` is the
    format's int8 table on the CPU (module docstring).  On CUDA tensors this
    launches K2's entry of the format (csrc/combine.cu), which reads every
    tile byte once and scans in the same launch, or raises; on CPU tensors it
    runs the plain version."""
    _check_tiles(tiles, bias, flags, tweak, kind, table)
    PERF["dispatches"] += 1
    if bias.device.type == "cuda":
        return _launch_tiles(tiles, bias, flags, tweak, kind, table)
    return pair_combine_scan_tiles_plain(tiles, bias, flags, tweak, kind,
                                         table)


def pair_combine_finish(c, w, end_idx):
    """(n_chains, 2) int32 [global, local] from the per-chunk scans at each
    chain's last chunk `end_idx` (pallas_combine.py:179-184)."""
    return torch.stack([c[end_idx], torch.clamp(w[end_idx], min=0)], dim=1)
