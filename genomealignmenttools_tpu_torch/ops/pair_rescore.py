"""Pair-mode chain rescoring: tiles of the aligned bases resident on the
device, and per-chain scores from K2 with only (n_chains, 2) fetched.

Counterpart of genomealignmenttools_tpu/ops/pair_rescore.py
(PairBlockScorer and PairChainScorer, pair_rescore.py:325-574, 786-978).
The host cuts the blocks into chunks of at most `chunk` bases and a native
packer (native/pairpack.cpp) writes one row of tiles a chunk in the format
GAT_PAIR_TILES names, chosen as the reference chooses it (:345-371):

    unset    int8 score tiles: lut8[q * 5 + t] a base, pad 0
             (`gat_pack_pairs_scored`, fill_scored)
    code     combined codes q * 5 + t a base, pad 24 = N/N
             (`gat_pack_pairs_combined`, fill_combined)
    score4   4-bit indices into the matrix's distinct values, two bases a
             byte, pad nibble 0 = value 0 (`gat_pack_pairs_scored4`,
             fill_scored4); int8 tiles where the matrix has more than 16
             distinct values (pack_vals16 gives None)

Every format needs a matrix of int8 entries with a zero N row and column:
the reference asserts both (pack_lut, pallas_rescore.py:175-178) before it
looks at GAT_PAIR_TILES, and so does lut8_of here.  The tiles are uploaded
once and cached by the identity of the blocks arrays.  Then:

    TorchPairBlockScorer   torch row sums of the format -> host, for the
                           native host combine (chunk_scores_multi,
                           block_scores_multi)
    TorchPairChainScorer   one launch of the format's K2 entry
                           (ops/pair_combine.py) that reads every tile byte
                           once, sums the rows and runs the three scans ->
                           finish, one (n_chains, 2) int32 fetch (score,
                           score_chained)

`pack_pairs`, `bucket_rows` and `pack_vals16` give the reference's arrays
byte for byte; parallel/mesh.py's ShardedPairScorer takes pack_pairs' tiles.
`pair_chain_scores_plain` is the reference's staged combine
(`_pair_chain_scores`, pair_rescore.py:606-745) in torch int64; it is the
oracle that K2 and its plain version are held against, and is on no path.

Re-decided for the H100 and not ported (ROADMAP.md): GAT_PAIR_SUM=dot (K2's
row sum is already a __dp4a against ones), the fixed-shape TILE_ROWS
streaming (it served fixed XLA compile shapes), the tile and meta shardings
and the staged/fused switch GAT_PAIR_COMBINE (they served GSPMD; on the card
the port always runs K2).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import PERF
from ..engines.scoring import gap_costs
from ..native import get_lib
from ..utils.bigmem import big_empty
from ..utils.profiling import phase
from .pair_combine import (CHUNK_MAX, CHUNK_MIN, F_FIRST, F_SAMPLE, F_START,
                           TILE, pair_combine_finish, pair_combine_scan_tiles,
                           tile_row_sums)
from .rescore import _n_threads
from .window_rescore import chunk_blocks

CHUNK = 128   # bases per tile row unless GAT_PAIR_CHUNK says otherwise
ROW_PAD = 1024   # pack_pairs' least row count (bucket_rows)
TILE_FORMATS = {None: "score8", "code": "code", "score4": "score4"}

# score_chained's feedback: no int32 score equals it, so the comparison is
# always false but makes every pass depend on the one before it
_FEEDBACK_SENTINEL = -(2 ** 62)


def pair_chunk() -> int:
    """Bases per tile row: GAT_PAIR_CHUNK (default CHUNK), as the reference
    reads it (pair_rescore.py:58), but checked: even (the native packers
    fill whole byte pairs) and from CHUNK_MIN = 2 to CHUNK_MAX = 258, so
    that chunk * 127 < 32768 and any chunk sum fits int16 as in the
    reference; the widths K2 takes."""
    raw = os.environ.get("GAT_PAIR_CHUNK", str(CHUNK))
    try:
        chunk = int(raw)
    except ValueError:
        raise ValueError(f"GAT_PAIR_CHUNK={raw!r} is not an integer") from None
    if not CHUNK_MIN <= chunk <= CHUNK_MAX or chunk % 2:
        raise ValueError(f"GAT_PAIR_CHUNK={chunk}: must be even and "
                         f"between {CHUNK_MIN} and {CHUNK_MAX}")
    return chunk


def pair_tiles() -> str:
    """The tile format GAT_PAIR_TILES names, as a K2 kind (pair_combine.
    KINDS): unset gives int8 score tiles ("score8"), `code` combined codes,
    `score4` 4-bit indices.  The reference reads only those two values and
    takes int8 tiles for any other (pair_rescore.py:362-369); the port
    raises on any other."""
    raw = os.environ.get("GAT_PAIR_TILES")
    if raw not in TILE_FORMATS:
        raise ValueError(f"GAT_PAIR_TILES={raw!r}: leave it unset (int8 "
                         f"score tiles) or set it to code or score4")
    return TILE_FORMATS[raw]


def lut8_of(lut: np.ndarray) -> np.ndarray:
    """int8[25] substitution scores indexed [q * 5 + t].  Raises unless
    every entry of the 5x5 matrix fits int8 and its N row and column are
    zero, in every tile format, as the reference's pack_lut asserts
    (pallas_rescore.py:175-178, called by PairBlockScorer.__init__ whatever
    GAT_PAIR_TILES says; tests/test_device_rescore.py:232-236)."""
    lut55 = np.asarray(lut, np.int64)[:5, :5]
    if lut55.shape != (5, 5) or np.any((lut55 < -128) | (lut55 > 127)):
        raise ValueError("pair mode needs a 5x5 score matrix of int8 values")
    if lut55[4].any() or lut55[:, 4].any():
        raise ValueError("pair mode needs a score matrix whose N row and "
                         "column are zero")
    return lut55.astype(np.int8).reshape(25)


def bucket_rows(m: int, floor: int = ROW_PAD) -> int:
    """m rounded up to the ladder {2^k * f, f in 1, 1.25, 1.5, 1.75} from
    `floor` (pair_rescore.py:62-77): pack_pairs' row count."""
    if m <= floor:
        return floor
    p = floor
    while p < m:
        p *= 2
    half = p // 2
    for f in (10, 12, 14):
        c = half * f // 8
        if c >= m:
            return c
    return p


def pack_vals16(lut: np.ndarray):
    """(idx_lut25 uint8[25], vals_packed int32[4]) for 4-bit score-index
    tiles, or None when the matrix has more than 16 distinct values or one
    outside int8 (pair_rescore.py:170-189).  Value 0 is index 0, so a pad
    nibble scores 0; value i is byte i % 4 of vals_packed[i // 4]."""
    lut55 = np.asarray(lut)[:5, :5]
    vals = sorted({int(v) for v in lut55.flatten()} | {0},
                  key=lambda v: (v != 0, v))
    if len(vals) > 16 or any(not -128 <= v <= 127 for v in vals):
        return None
    vals += [0] * (16 - len(vals))
    of = {v: i for i, v in enumerate(vals)}
    idx_lut25 = np.zeros(25, np.uint8)
    for q in range(5):
        for t in range(5):
            idx_lut25[q * 5 + t] = of[int(lut55[q, t])]
    packed = np.zeros(4, np.int64)
    for i, v in enumerate(vals):
        packed[i // 4] |= (v & 0xFF) << ((i % 4) * 8)
    return idx_lut25, packed.astype(np.uint32).astype(np.int32)


def vals16_of(vals_packed: np.ndarray) -> np.ndarray:
    """The 16 int8 values of pack_vals16's vals_packed, in index order."""
    return np.ascontiguousarray(vals_packed, "<i4").view(np.int8).copy()


def _check_chunks(t_codes, q_codes, t_off, q_off, length, k: int,
                  chunk: int) -> np.ndarray:
    """Raises before a packer could read outside a genome; returns the
    lengths as contiguous int64."""
    length = np.ascontiguousarray(length, np.int64)
    if k and (length.min() < 0 or length.max() > chunk
              or min(t_off.min(), q_off.min()) < 0
              or (t_off + length).max() > t_codes.shape[0]
              or (q_off + length).max() > q_codes.shape[0]):
        raise IndexError("a chunk lies outside its genome code array or is "
                         f"not 0..{chunk} bases long")
    return length


def _pack_native(fn, t_codes, q_codes, t_off, q_off, length, k: int,
                 chunk: int, *rest) -> None:
    """Call one of the native packers on contiguous arrays; `rest` are its
    arguments after the chunk width (tables and the output), as ctypes
    pointers."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    t_off = np.ascontiguousarray(t_off, np.int64)
    q_off = np.ascontiguousarray(q_off, np.int64)
    fn(t_codes.ctypes.data_as(u8p), q_codes.ctypes.data_as(u8p),
       t_off.ctypes.data_as(i64p), q_off.ctypes.data_as(i64p),
       length.ctypes.data_as(i64p), k, chunk, *rest, _n_threads())


def _combined_codes(t_codes, q_codes, t_off, q_off, length, chunk: int):
    """numpy: (k, chunk) int combined codes and the mask of live bases."""
    lane = np.arange(chunk, dtype=np.int64)
    t_idx = np.minimum(t_off[:, None] + lane, t_codes.shape[0] - 1)
    q_idx = np.minimum(q_off[:, None] + lane, q_codes.shape[0] - 1)
    combined = q_codes[q_idx].astype(np.intp) * 5 + t_codes[t_idx]
    return combined, lane < length[:, None]


def fill_scored(t_codes, q_codes, t_off, q_off, length, out, lut8) -> None:
    """Fill the (k, chunk) int8 rows `out` with lut8[q * 5 + t] per aligned
    base, 0 past each chunk's length: the native packer, or numpy without
    the native library (GAT_NATIVE=0), as _fill_scored does
    (pair_rescore.py:257-279).  Raises before the packer could read outside
    a genome."""
    k, chunk = out.shape
    length = _check_chunks(t_codes, q_codes, t_off, q_off, length, k, chunk)
    t_codes = np.ascontiguousarray(t_codes, np.uint8)
    q_codes = np.ascontiguousarray(q_codes, np.uint8)
    lib = get_lib()
    if lib is not None:
        i8p = ctypes.POINTER(ctypes.c_int8)
        _pack_native(lib.gat_pack_pairs_scored, t_codes, q_codes, t_off,
                     q_off, length, k, chunk, lut8.ctypes.data_as(i8p),
                     out.ctypes.data_as(i8p))
        return
    combined, live = _combined_codes(t_codes, q_codes, t_off, q_off, length,
                                     chunk)
    out[:] = np.where(live, lut8[combined], np.int8(0))


def fill_combined(t_codes, q_codes, t_off, q_off, length, out) -> None:
    """Fill the (k, chunk) uint8 rows `out` with the combined code q * 5 + t
    per aligned base, 24 (N/N) past each chunk's length: the native packer,
    or numpy under GAT_NATIVE=0, as _fill_combined does (pair_rescore.py:
    233-255), with fill_scored's bounds check."""
    k, chunk = out.shape
    length = _check_chunks(t_codes, q_codes, t_off, q_off, length, k, chunk)
    t_codes = np.ascontiguousarray(t_codes, np.uint8)
    q_codes = np.ascontiguousarray(q_codes, np.uint8)
    lib = get_lib()
    if lib is not None:
        _pack_native(lib.gat_pack_pairs_combined, t_codes, q_codes, t_off,
                     q_off, length, k, chunk,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return
    combined, live = _combined_codes(t_codes, q_codes, t_off, q_off, length,
                                     chunk)
    out[:] = np.where(live, combined, 24).astype(np.uint8)


def fill_scored4(t_codes, q_codes, t_off, q_off, length, out,
                 idx_lut25) -> None:
    """Fill the (k, chunk // 2) uint8 rows `out` with 4-bit score indices,
    idx_lut25[q * 5 + t] per aligned base, base 2i in the low nibble of byte
    i and base 2i + 1 in the high one, 0 past each chunk's length: the
    native packer, or numpy under GAT_NATIVE=0, as _fill_scored4 does
    (pair_rescore.py:283-306), with fill_scored's bounds check."""
    k, chunk = out.shape[0], 2 * out.shape[1]
    length = _check_chunks(t_codes, q_codes, t_off, q_off, length, k, chunk)
    t_codes = np.ascontiguousarray(t_codes, np.uint8)
    q_codes = np.ascontiguousarray(q_codes, np.uint8)
    idx_lut25 = np.ascontiguousarray(idx_lut25, np.uint8)
    lib = get_lib()
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        _pack_native(lib.gat_pack_pairs_scored4, t_codes, q_codes, t_off,
                     q_off, length, k, chunk, idx_lut25.ctypes.data_as(u8p),
                     out.ctypes.data_as(u8p))
        return
    combined, live = _combined_codes(t_codes, q_codes, t_off, q_off, length,
                                     chunk)
    idx = np.where(live, idx_lut25[combined], np.uint8(0))
    out[:] = idx[:, 0::2] | (idx[:, 1::2] << 4)


def pack_pairs(t_codes: np.ndarray, q_codes: np.ndarray, blocks: np.ndarray,
               chunk: int | None = None):
    """(c8 uint8 (bucket_rows(m), chunk), c_block int64[m], m): the combined
    q * 5 + t tiles of one (t, q, strand) group's blocks, rows past m all 24
    (N/N), as the reference's pack_pairs (pair_rescore.py:309-322) writes
    them; chunk defaults to pair_chunk()."""
    chunk = pair_chunk() if chunk is None else chunk
    t_off, q_off, length, c_block = chunk_blocks(blocks, chunk)
    m = t_off.shape[0]
    c8 = np.empty((bucket_rows(m), chunk), np.uint8)
    c8[m:] = 24
    fill_combined(t_codes, q_codes, t_off, q_off, length, c8[:m])
    return c8, c_block, m


class PairPack(NamedTuple):
    tiles: torch.Tensor      # (m_pad, width) tiles of `kind` on the device
    c_block: np.ndarray      # block (across jobs) of each of the m chunks
    m: int                   # real chunks; rows m..m_pad are pad rows
    n_blocks: int
    kind: str                # "score8", "code" or "score4" (pair_combine)
    table: torch.Tensor | None   # the kind's int8 table on the CPU


class TorchPairBlockScorer:
    """Block scorer over tiles resident on one device, in the format
    GAT_PAIR_TILES names (`kind`: pair_tiles, and int8 where score4 finds
    more than 16 distinct values); the contract of PairBlockScorer
    (pair_rescore.py:325-574).

    `host_native` is False, as WindowBlockScorer's, so chainCleaner and
    chainNet -rescore batch their sub-chains through score_subsets.  With
    `host_native=True` (pair_rescore.py:332-348, 478-525) nothing is
    packed, uploaded or launched: chunk_scores_multi returns per-block LUT
    sums from the threaded C++ pass over the host genome arrays (numpy
    chunk sums without the native library), and the engines take their
    all-native paths.  TorchChainScorer builds it only in the mode
    `hostnative`."""

    def __init__(self, lut: np.ndarray, t_genome, q_genome,
                 device: str | torch.device, host_native: bool = False):
        self.host_native = host_native
        self.kind, self.table = "score8", None
        if host_native:
            # flat [q * 5 + t], padded to 256 so any byte value indexes safely
            self.lut25 = np.zeros(256, np.int32)
            self.lut25[:25] = np.asarray(lut, np.int64)[:5, :5].reshape(25)
        else:
            self.lut8 = lut8_of(lut)
            self.kind = pair_tiles()
            if self.kind == "code":
                self.table = torch.from_numpy(self.lut8.copy())
            elif self.kind == "score4":
                v16 = pack_vals16(lut)
                if v16 is None:
                    self.kind = "score8"
                else:
                    self.idx_lut25 = v16[0]
                    self.table = torch.from_numpy(vals16_of(v16[1]))
        self.chunk = pair_chunk()
        self.t_genome = t_genome
        self.q_genome = q_genome
        self.device = torch.device(device)
        self._pack_cache: dict = {}

    def _pack(self, jobs) -> PairPack:
        """Tiles of every job's chunks in the scorer's format, pad rows up
        to a multiple of K2's tile (0 for int8 and nibbles, 24 for codes);
        cached by the identity of the jobs' blocks arrays, which the cache
        pins (_pack_cached, pair_rescore.py:427-436)."""
        key = tuple(id(b) for (_, _, _, b) in jobs)
        hit = self._pack_cache.get(key)
        if hit is not None and all(a is b for a, (_, _, _, b) in
                                   zip(hit[0], jobs)):
            return hit[1]
        with phase("rescore: pair pack"):
            parts, c_blocks, n_blocks = [], [], 0
            for (tn, qn, strand, blocks) in jobs:
                t_off, q_off, length, c_block = chunk_blocks(blocks,
                                                             self.chunk)
                parts.append((self.t_genome.codes(tn, "+"),
                              self.q_genome.codes(qn, strand),
                              t_off, q_off, length))
                c_blocks.append(c_block + n_blocks)
                n_blocks += blocks.shape[0]
            m = sum(p[2].shape[0] for p in parts)
            m_pad = -(-m // TILE) * TILE
            width = self.chunk // 2 if self.kind == "score4" else self.chunk
            s8 = big_empty((m_pad, width),
                           np.int8 if self.kind == "score8" else np.uint8)
            s8[m:] = 24 if self.kind == "code" else 0
            row = 0
            for (tc, qc, t_off, q_off, length) in parts:
                k = t_off.shape[0]
                out = s8[row:row + k]
                if self.kind == "code":
                    fill_combined(tc, qc, t_off, q_off, length, out)
                elif self.kind == "score4":
                    fill_scored4(tc, qc, t_off, q_off, length, out,
                                 self.idx_lut25)
                else:
                    fill_scored(tc, qc, t_off, q_off, length, out, self.lut8)
                row += k
        with phase("rescore: pair tiles to device"):
            tiles = torch.from_numpy(s8).to(self.device)
        if self.device.type != "cpu":
            PERF["h2d_bytes"] += s8.nbytes
        c_block = (np.concatenate(c_blocks) if c_blocks
                   else np.zeros(0, np.int64))
        pack = PairPack(tiles, c_block, m, n_blocks, self.kind, self.table)
        if len(self._pack_cache) > 16:
            self._pack_cache.clear()
        self._pack_cache[key] = ([b for (_, _, _, b) in jobs], pack)
        return pack

    def chunk_sums(self, jobs) -> torch.Tensor:
        """(m_pad,) int32 chunk sums on the device, pad rows 0: the format's
        row sums in torch ops (tile_row_sums, the XLA jits _chunk_sums_i32*
        of pair_rescore.py)."""
        pack = self._pack(jobs)
        PERF["dispatches"] += 1
        return tile_row_sums(pack.tiles, pack.kind, pack.table)

    def chunk_scores_multi(self, jobs):
        """(chunk_scores int32[m], c_block int64[m], n_blocks) across jobs
        [(t_name, q_name, q_strand, blocks)], one pass and one fetch.
        Host-native: (block_scores int64, None, n_blocks) from the fused
        native pass, or chunk sums from numpy."""
        if self.host_native:
            return self._chunk_scores_host(jobs)
        pack = self._pack(jobs)
        if pack.m == 0:
            return np.zeros(0, np.int32), pack.c_block, pack.n_blocks
        with phase("rescore: wait + sums to host"):
            cs = self.chunk_sums(jobs)[:pack.m].cpu().numpy()
        if self.device.type != "cpu":
            PERF["d2h_bytes"] += cs.nbytes
        return cs, pack.c_block, pack.n_blocks

    def _chunk_scores_host(self, jobs):
        """No device (pair_rescore.py:481-525): gat_block_scores_direct sums
        lut25 per block straight from the genome arrays; without the native
        library, numpy chunk sums."""
        lib = get_lib()
        n_blocks = sum(b.shape[0] for (_, _, _, b) in jobs)
        outs, cbs, base = [], [], 0
        for (tn, qn, strand, blocks) in jobs:
            tc = np.ascontiguousarray(self.t_genome.codes(tn, "+"))
            qc = np.ascontiguousarray(self.q_genome.codes(qn, strand))
            if lib is not None:
                u8p = ctypes.POINTER(ctypes.c_uint8)
                i64p = ctypes.POINTER(ctypes.c_int64)
                b = np.ascontiguousarray(blocks, np.int64)
                bs = np.empty(b.shape[0], np.int64)
                lib.gat_block_scores_direct(
                    tc.ctypes.data_as(u8p), qc.ctypes.data_as(u8p),
                    b.ctypes.data_as(i64p), b.shape[0],
                    self.lut25.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    bs.ctypes.data_as(i64p), _n_threads())
                outs.append(bs)
                continue
            t_off, q_off, length, c_block = chunk_blocks(blocks, self.chunk)
            lane = np.arange(self.chunk, dtype=np.int64)
            t_idx = np.minimum(t_off[:, None] + lane, tc.shape[0] - 1)
            q_idx = np.minimum(q_off[:, None] + lane, qc.shape[0] - 1)
            vals = self.lut25[qc[q_idx].astype(np.intp) * 5 + tc[t_idx]]
            outs.append(np.where(lane < length[:, None], vals, 0)
                        .sum(axis=1).astype(np.int32))
            cbs.append(c_block + base)
            base += blocks.shape[0]
        if lib is not None:
            flat = np.concatenate(outs) if outs else np.zeros(0, np.int64)
            return flat, None, n_blocks
        if not outs:
            return np.zeros(0, np.int32), np.zeros(0, np.int64), 0
        return np.concatenate(outs), np.concatenate(cbs), n_blocks

    def block_scores_multi(self, jobs) -> np.ndarray:
        cs, c_block, n_blocks = self.chunk_scores_multi(jobs)
        if c_block is None:     # host-native: already per-block totals
            return cs
        out = np.zeros(n_blocks, np.int64)
        np.add.at(out, c_block, cs.astype(np.int64))
        return out

    def block_scores(self, t_name: str, q_name: str, q_strand: str,
                     blocks: np.ndarray) -> np.ndarray:
        """int64[n] per-block scores for (n, 4) blocks [tS, tE, qS, qE]."""
        if blocks.shape[0] == 0:
            return np.zeros(0, np.int64)
        return self.block_scores_multi([(t_name, q_name, q_strand, blocks)])


def pair_chain_scores_plain(s, bias, flags, start_idx, end_idx):
    """(n_chains, 2) int64 [global, local]: the reference's staged combine
    (_pair_chain_scores, pair_rescore.py:606-745) in torch int64 on the
    tensors' device.  Segments come from arithmetic, not resets: the chain
    prefix sum is a global cumsum less each chain's starting prefix, and the
    running min and max see each chain offset by chain_id * 2^33, so a later
    chain always dominates an earlier one.  Chunks past the last chain start
    (pad chunks) belong to the last chain."""
    big = 1 << 62
    inc = 1 << 33
    s64 = s.to(torch.int64)
    g = torch.cumsum(s64 - bias.to(torch.int64), 0)
    starts = torch.zeros(s.numel(), dtype=torch.int64, device=s.device)
    starts[start_idx] = 1
    chain_of = torch.cumsum(starts, 0) - 1
    base = torch.where(start_idx > 0, g[(start_idx - 1).clamp(min=0)], 0)
    c = g - base[chain_of]
    first = (flags & F_FIRST) != 0
    sample = (flags & F_SAMPLE) != 0
    off = chain_of * inc
    m = torch.minimum(torch.where(sample, c, big),
                      torch.where(first, c - s64, big))
    runmin = torch.clamp(torch.cummin(m - off, 0).values + off, max=0)
    sv = torch.where(sample, c - runmin, -big) + off
    runmax = torch.cummax(sv, 0).values - off
    return torch.stack([c[end_idx], torch.clamp(runmax[end_idx], min=0)], 1)


class PairMeta(NamedTuple):
    bias: torch.Tensor       # (m_pad,) int32 on the device
    flags: torch.Tensor      # (m_pad,) int32 on the device
    end_idx: torch.Tensor    # (n_chains,) int64 on the device
    start_idx: np.ndarray    # (n_chains,) int64: first chunk of each chain
    ali: np.ndarray          # (n_chains,) int64 aligned bases


class TorchPairChainScorer:
    """(global, local, aliBases) of whole workloads with one fetch of
    (n_chains, 2) int32; the contract of PairChainScorer
    (pair_rescore.py:786-978), always through K2 on the card."""

    def __init__(self, pair: TorchPairBlockScorer, gap_calc):
        self.pair = pair
        self.gap_calc = gap_calc
        self._meta_cache: dict = {}

    def _meta(self, jobs, chain_nblocks) -> PairMeta:
        """Scan metadata of the chains (chain k has chain_nblocks[k] blocks,
        in job order), cached like the pack (pair_rescore.py:799-874).
        Raises OverflowError when a chain's scores could leave int32."""
        ck = (tuple(id(b) for (_, _, _, b) in jobs), tuple(chain_nblocks))
        hit = self._meta_cache.get(ck)
        if hit is not None and all(a is b for a, (_, _, _, b) in
                                   zip(hit[0], jobs)):
            return hit[1]
        pack = self.pair._pack(jobs)
        m, c_block = pack.m, pack.c_block
        nb = np.asarray(chain_nblocks, np.int64)
        if nb.sum() != pack.n_blocks or (nb < 1).any():
            raise ValueError("chain block counts do not cover the jobs' "
                             "blocks, or a chain has no block")
        all_blocks = np.concatenate([b for (_, _, _, b) in jobs])
        block_start = np.cumsum(nb) - nb
        # gap cost before each block, 0 at chain starts
        gc_all = np.zeros(pack.n_blocks, np.int64)
        gc_all[1:] = gap_costs(all_blocks, self.gap_calc)
        gc_all[block_start] = 0
        ali = np.add.reduceat(
            (all_blocks[:, 1] - all_blocks[:, 0]).astype(np.int64),
            block_start)
        # int32 scan guard: |any chain prefix| <= ali * 127 + gap total
        bound = ali * 127 + np.add.reduceat(gc_all, block_start)
        if bound.max() >= 2 ** 31:
            raise OverflowError("chain score bound exceeds int32; "
                                "use the host combine")
        is_first = np.ones(m, bool)
        is_first[1:] = c_block[1:] != c_block[:-1]
        is_last = np.ones(m, bool)
        is_last[:-1] = is_first[1:]
        chain_of_chunk = np.repeat(np.arange(nb.shape[0]), nb)[c_block]
        start_idx = np.flatnonzero(
            np.r_[True, chain_of_chunk[1:] != chain_of_chunk[:-1]])
        end_idx = np.r_[start_idx[1:] - 1, m - 1]
        # pad chunks (m..m_pad) have flags 0 and bias 0: they continue the
        # last chain and are inert
        m_pad = pack.tiles.shape[0]
        flags = np.zeros(m_pad, np.int32)
        flags[:m] = is_first * F_FIRST + is_last * F_SAMPLE
        flags[start_idx] |= F_START
        bias = np.zeros(m_pad, np.int32)
        bias[:m][is_first] = gc_all[c_block[is_first]]
        dev = self.pair.device
        if dev.type != "cpu":
            PERF["h2d_bytes"] += bias.nbytes + flags.nbytes + end_idx.nbytes
        meta = PairMeta(torch.from_numpy(bias).to(dev),
                        torch.from_numpy(flags).to(dev),
                        torch.from_numpy(end_idx).to(dev), start_idx, ali)
        if len(self._meta_cache) > 8:
            self._meta_cache.clear()
        self._meta_cache[ck] = ([b for (_, _, _, b) in jobs], meta)
        return meta

    def _pass(self, jobs, meta: PairMeta, tweak=None) -> torch.Tensor:
        """One pass: the format's K2 entry from the resident tiles (row sums
        plus `tweak`, and the scans, in one launch), then the finish."""
        pack = self.pair._pack(jobs)
        c, w = pair_combine_scan_tiles(pack.tiles, meta.bias, meta.flags,
                                       tweak, pack.kind, pack.table)
        return pair_combine_finish(c, w, meta.end_idx)

    def score_async(self, jobs, chain_nblocks) -> torch.Tensor:
        """Queue one full pass; the (n_chains, 2) int32 device tensor,
        not waited for."""
        return self._pass(jobs, self._meta(jobs, chain_nblocks))

    def score(self, jobs, chain_nblocks) -> list[tuple[float, float, int]]:
        """[(global, local, aliBases)] per chain, one fetch."""
        if len(chain_nblocks) == 0:
            return []
        ali = self._meta(jobs, chain_nblocks).ali
        with phase("rescore: pair pass + fetch"):
            out = self.score_async(jobs, chain_nblocks).cpu().numpy()
        if self.pair.device.type != "cpu":
            PERF["d2h_bytes"] += out.nbytes
        return [(float(g), float(loc), int(a))
                for (g, loc), a in zip(out.tolist(), ali.tolist())]

    def score_chained(self, jobs, chain_nblocks, n: int) -> np.ndarray:
        """n passes, each made to depend on the one before through an int64
        comparison with a value no score reaches, then one fetch: the
        sustained-throughput protocol of pair_rescore.py:904-943.  The
        reference's fused chain compares the int32 score with INT32_MIN,
        which a real score could equal."""
        if n < 1:
            raise ValueError(f"n must be at least 1, got {n}")
        meta = self._meta(jobs, chain_nblocks)
        fb = torch.zeros(2, dtype=torch.int64, device=self.pair.device)
        out = None
        for _ in range(n):
            tweak = (fb[0] == _FEEDBACK_SENTINEL).to(torch.int32)
            out = self._pass(jobs, meta, tweak)
            fb = out[0].to(torch.int64)
        return out.cpu().numpy()

    def resident_hbm_bytes(self, jobs, chain_nblocks) -> int:
        """Device bytes K2 reads and writes in a pass: the tiles' bytes in
        their format (a byte a base for int8 and codes, half a byte for
        nibbles, pad rows included), bias and flags read once, c and w
        written once (4 bytes each a chunk).  The finish's (n_chains, 2) is
        left out."""
        self._meta(jobs, chain_nblocks)
        tiles = self.pair._pack(jobs).tiles
        return int(tiles.numel() + 4 * 4 * tiles.shape[0])
