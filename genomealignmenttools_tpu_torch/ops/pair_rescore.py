"""Pair-mode chain rescoring: int8 score tiles resident on the device, chunk
sums, and per-chain scores from K2 with only (n_chains, 2) fetched.

Counterpart of genomealignmenttools_tpu/ops/pair_rescore.py with its int8
score tiles (PairBlockScorer and PairChainScorer, pair_rescore.py:325-574,
786-978).  The host cuts the blocks into chunks of at most `chunk` bases
and the native packer (`gat_pack_pairs_scored`, native/pairpack.cpp:98)
writes one int8 substitution score per aligned base, zero past a chunk's
end, into (m, chunk) tiles, uploaded once and cached by the identity of the
blocks arrays.  A pass is then a row sum and the combine:

    TorchPairBlockScorer   chunk sums -> host, for the native host combine
                           (chunk_scores_multi, block_scores_multi)
    TorchPairChainScorer   chunk sums -> K2 (ops/pair_combine.py) -> finish,
                           one (n_chains, 2) int32 fetch (score, score_chained)

`pair_chain_scores_plain` is the reference's staged combine
(`_pair_chain_scores`, pair_rescore.py:606-745) in torch int64; it is the
oracle that K2 and its plain version are held against, and is on no path.

Not ported (TPU tuning with the same outputs; to re-decide on an H100
measurement, ROADMAP.md): score4 nibble tiles, combined-code tiles,
GAT_PAIR_SUM=dot, the fixed-shape TILE_ROWS streaming, the tile and meta
shardings, and the staged/fused switch: on the card the port always uses K2.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from genomealignmenttools_tpu.engines.scoring import gap_costs
from genomealignmenttools_tpu.native import get_lib
from genomealignmenttools_tpu.ops.rescore import _n_threads
from genomealignmenttools_tpu.utils.bigmem import big_empty
from genomealignmenttools_tpu.utils.profiling import phase

from ..device import PERF
from .pair_combine import (F_FIRST, F_SAMPLE, F_START, TILE,
                           pair_combine_finish, pair_combine_scan)
from .window_rescore import chunk_blocks

CHUNK = 128   # bases per tile row unless GAT_PAIR_CHUNK says otherwise

# score_chained's feedback: no int32 score equals it, so the comparison is
# always false but makes every pass depend on the one before it
_FEEDBACK_SENTINEL = -(2 ** 62)


def pair_chunk() -> int:
    """Bases per tile row: GAT_PAIR_CHUNK (default CHUNK), as the reference
    reads it (pair_rescore.py:58), but checked: even (the native packers
    fill whole byte pairs), at least 2, and chunk * 127 < 32768 so that any
    chunk sum fits int16 as in the reference."""
    raw = os.environ.get("GAT_PAIR_CHUNK", str(CHUNK))
    try:
        chunk = int(raw)
    except ValueError:
        raise ValueError(f"GAT_PAIR_CHUNK={raw!r} is not an integer") from None
    if chunk < 2 or chunk % 2 or chunk * 127 >= 32768:
        raise ValueError(f"GAT_PAIR_CHUNK={chunk}: must be even and "
                         "between 2 and 258")
    return chunk


def lut8_of(lut: np.ndarray) -> np.ndarray:
    """int8[25] substitution scores indexed [q * 5 + t]; raises unless every
    entry of the 5x5 matrix fits int8 (the reference then packs combined
    codes instead, which the port does not have)."""
    lut55 = np.asarray(lut, np.int64)[:5, :5]
    if lut55.shape != (5, 5) or np.any((lut55 < -128) | (lut55 > 127)):
        raise ValueError("pair mode needs a 5x5 score matrix of int8 values")
    return lut55.astype(np.int8).reshape(25)


def fill_scored(t_codes, q_codes, t_off, q_off, length, out, lut8) -> None:
    """Fill the (k, chunk) int8 rows `out` with lut8[q * 5 + t] per aligned
    base, 0 past each chunk's length: the native packer, or numpy without
    the native library (GAT_NATIVE=0), as _fill_scored does
    (pair_rescore.py:257-279).  Raises before the packer could read outside
    a genome."""
    k, chunk = out.shape
    length = np.ascontiguousarray(length, np.int64)
    if k and (length.min() < 0 or length.max() > chunk
              or min(t_off.min(), q_off.min()) < 0
              or (t_off + length).max() > t_codes.shape[0]
              or (q_off + length).max() > q_codes.shape[0]):
        raise IndexError("a chunk lies outside its genome code array or is "
                         f"not 0..{chunk} bases long")
    t_codes = np.ascontiguousarray(t_codes, np.uint8)
    q_codes = np.ascontiguousarray(q_codes, np.uint8)
    lib = get_lib()
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        t_off = np.ascontiguousarray(t_off, np.int64)
        q_off = np.ascontiguousarray(q_off, np.int64)
        lib.gat_pack_pairs_scored(
            t_codes.ctypes.data_as(u8p), q_codes.ctypes.data_as(u8p),
            t_off.ctypes.data_as(i64p), q_off.ctypes.data_as(i64p),
            length.ctypes.data_as(i64p), k, chunk,
            lut8.ctypes.data_as(i8p), out.ctypes.data_as(i8p), _n_threads())
        return
    lane = np.arange(chunk, dtype=np.int64)
    t_idx = np.minimum(t_off[:, None] + lane, t_codes.shape[0] - 1)
    q_idx = np.minimum(q_off[:, None] + lane, q_codes.shape[0] - 1)
    combined = q_codes[q_idx].astype(np.intp) * 5 + t_codes[t_idx]
    out[:] = np.where(lane < length[:, None], lut8[combined], np.int8(0))


class PairPack(NamedTuple):
    tiles: torch.Tensor      # (m_pad, chunk) int8 on the device
    c_block: np.ndarray      # block (across jobs) of each of the m chunks
    m: int                   # real chunks; rows m..m_pad are zero
    n_blocks: int


class TorchPairBlockScorer:
    """Block scorer over int8 score tiles resident on one device; the
    contract of PairBlockScorer (pair_rescore.py:325-574) with score tiles.

    `host_native` is False, as WindowBlockScorer's, so chainCleaner and
    chainNet -rescore batch their sub-chains through score_chains."""

    host_native = False

    def __init__(self, lut: np.ndarray, t_genome, q_genome,
                 device: str | torch.device):
        self.lut8 = lut8_of(lut)
        self.chunk = pair_chunk()
        self.t_genome = t_genome
        self.q_genome = q_genome
        self.device = torch.device(device)
        self._pack_cache: dict = {}

    def _pack(self, jobs) -> PairPack:
        """Tiles of every job's chunks, rows padded with zeros to a multiple
        of K2's tile; cached by the identity of the jobs' blocks arrays,
        which the cache pins (_pack_cached, pair_rescore.py:427-436)."""
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
            s8 = big_empty((m_pad, self.chunk), np.int8)
            s8[m:] = 0
            row = 0
            for (tc, qc, t_off, q_off, length) in parts:
                k = t_off.shape[0]
                fill_scored(tc, qc, t_off, q_off, length, s8[row:row + k],
                            self.lut8)
                row += k
        with phase("rescore: pair tiles to device"):
            tiles = torch.from_numpy(s8).to(self.device)
        if self.device.type != "cpu":
            PERF["h2d_bytes"] += s8.nbytes
        c_block = (np.concatenate(c_blocks) if c_blocks
                   else np.zeros(0, np.int64))
        pack = PairPack(tiles, c_block, m, n_blocks)
        if len(self._pack_cache) > 16:
            self._pack_cache.clear()
        self._pack_cache[key] = ([b for (_, _, _, b) in jobs], pack)
        return pack

    def chunk_sums(self, jobs) -> torch.Tensor:
        """(m_pad,) int32 chunk sums on the device, pad rows 0 (the XLA row
        sum _chunk_sums_i32_scored, pair_rescore.py:131-134)."""
        tiles = self._pack(jobs).tiles
        PERF["dispatches"] += 1
        return tiles.sum(dim=1, dtype=torch.int32)

    def chunk_scores_multi(self, jobs):
        """(chunk_scores int32[m], c_block int64[m], n_blocks) across jobs
        [(t_name, q_name, q_strand, blocks)], one pass and one fetch."""
        pack = self._pack(jobs)
        if pack.m == 0:
            return np.zeros(0, np.int32), pack.c_block, pack.n_blocks
        with phase("rescore: wait + sums to host"):
            cs = self.chunk_sums(jobs)[:pack.m].cpu().numpy()
        if self.device.type != "cpu":
            PERF["d2h_bytes"] += cs.nbytes
        return cs, pack.c_block, pack.n_blocks

    def block_scores_multi(self, jobs) -> np.ndarray:
        cs, c_block, n_blocks = self.chunk_scores_multi(jobs)
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
        s = self.pair.chunk_sums(jobs)
        if tweak is not None:
            s = s + tweak
        c, w = pair_combine_scan(s, meta.bias, meta.flags)
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
        """Device bytes a pass reads and writes at least: the int8 tiles,
        then s, bias and flags read and c and w written by the combine."""
        self._meta(jobs, chain_nblocks)
        tiles = self.pair._pack(jobs).tiles
        return int(tiles.numel() + 5 * 4 * tiles.shape[0])
