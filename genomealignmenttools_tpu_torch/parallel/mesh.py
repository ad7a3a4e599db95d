"""Device lists and sharded batched rescoring.

Counterpart of genomealignmenttools_tpu/parallel/mesh.py.  A mesh is a tuple
of torch.devices; an entry may repeat (["cuda:0"] * 4 on a one-card machine,
["cpu"] * 8 in the tests), and each entry is one shard.

    ShardedBlockScorer   per-block scores; blocks cut into contiguous
                         equal-count shards (mesh.py:63-97), each run through
                         K1 (CPU: its plain version) over genome codes
                         replicated on its device
    ShardedPairScorer    chunk sums of the port's int8 score tiles, cut into
                         contiguous row shards (mesh.py:127-147)
    ShardedChainScorer   (global, local, aliBases) of whole chain sets; the
                         chains are cut into contiguous shards at chain
                         boundaries, each a whole pair scorer with K2 on its
                         device (mesh.py:150-186)

Why ShardedChainScorer cuts at chain boundaries: the JAX version row-shards
the tiles evenly and lets GSPMD insert the combine's cross-shard carries;
torch has no GSPMD.  A chain's scores depend only on its own chunks, so a
shard that holds whole chains needs no carry at all: it runs row sums, K2
and the finish alone, and only the (n_chains_shard, 2) results are
gathered.  The cut before shard i is the chain start nearest i * M / n,
where M is the chunk count of the set (chain_cuts), so shards are balanced
by chunks (aligned bases) as far as whole chains allow.  Outputs do not
depend on where the cuts fall.
"""

from __future__ import annotations

import numpy as np
import torch

from genomealignmenttools_tpu.parallel.distributed import shard_indices

from ..device import PERF, resolve_device
from ..ops.pair_rescore import fill_scored, lut8_of, pair_chunk
from ..ops.rescore import TorchChainScorer
from ..ops.window_rescore import checked_lut, chunk_blocks, chunk_sums


def make_mesh(n_devices: int | None = None,
              devices=None) -> tuple[torch.device, ...]:
    """The devices of a mesh.  Default: cuda:0 .. cuda:n-1 over the visible
    cards (n_devices of them, or all), raising without CUDA; `devices` names
    them instead (repeats allowed), cut to n_devices if given.  The CPU is a
    mesh only when named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; name the "
                               "devices, e.g. devices=['cpu'] * 2")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked, {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = list(devices)[:n_devices]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: no devices")
    for d in mesh:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"make_mesh: {d} is not a visible card")
    return mesh


def _mesh_of(mesh) -> tuple[torch.device, ...]:
    return make_mesh() if mesh is None else make_mesh(devices=mesh)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    if dev.type != "cpu":
        PERF["h2d_bytes"] += a.nbytes
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _fetch(t: torch.Tensor) -> np.ndarray:
    host = t.cpu().numpy()
    if t.device.type != "cpu":
        PERF["d2h_bytes"] += host.nbytes
    return host


class ShardedBlockScorer:
    """Multi-device block scorer: blocks cut into contiguous equal-count
    shards, genome codes replicated on every device of the mesh."""

    def __init__(self, lut: np.ndarray, mesh=None):
        self.mesh = _mesh_of(mesh)
        self.lut = checked_lut(lut)
        self.n_dev = len(self.mesh)
        self._genome_cache: dict = {}

    def put_genome(self, codes: np.ndarray,
                   device: torch.device) -> torch.Tensor:
        """`codes` on `device`, uploaded once.  Keyed by the id() of the
        host array, which the entry pins, so a reused id() never serves a
        stale genome (the reference keys by a bare id, mesh.py:56-61)."""
        key = (id(codes), str(device))
        hit = self._genome_cache.get(key)
        if hit is not None and hit[0] is codes:
            return hit[1]
        dev_codes = _upload(np.asarray(codes, np.uint8), device)
        self._genome_cache[key] = (codes, dev_codes)
        return dev_codes

    def block_scores(self, t_codes: np.ndarray, q_codes: np.ndarray,
                     blocks: np.ndarray) -> np.ndarray:
        """int64[n] per-block scores of (n, 4) blocks [tS, tE, qS, qE]; every
        shard is launched before the first result is fetched."""
        n = blocks.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        per = -(-n // self.n_dev)
        queued = []
        for d, dev in enumerate(self.mesh):
            part = blocks[d * per:(d + 1) * per]
            if part.shape[0] == 0:
                break
            t_off, q_off, length, c_block = chunk_blocks(part)
            out = chunk_sums(self.put_genome(t_codes, dev),
                             self.put_genome(q_codes, dev), self.lut,
                             *(_upload(a, dev) for a in (t_off, q_off,
                                                         length)))
            queued.append((part.shape[0], c_block, out))
        parts = []
        for k, c_block, out in queued:
            scores = np.zeros(k, np.int64)
            np.add.at(scores, c_block, _fetch(out).astype(np.int64))
            parts.append(scores)
        return np.concatenate(parts)


class ShardedPairScorer:
    """Multi-device chunk sums of int8 score tiles, cut into contiguous row
    shards.  The port has only score tiles (ops/pair_rescore.py), not the
    reference's combined-code tiles of pack_pairs, so this takes the tiles
    that `pack` (fill_scored) writes and returns the same chunk scores for
    the same chunks, in chunk_blocks order.  Tiles are genome-agnostic: no
    genome is replicated."""

    def __init__(self, lut: np.ndarray, mesh=None):
        self.mesh = _mesh_of(mesh)
        self.lut8 = lut8_of(lut)
        self.n_dev = len(self.mesh)

    def pack(self, t_codes: np.ndarray, q_codes: np.ndarray,
             blocks: np.ndarray):
        """(tiles int8 (m, chunk), c_block int64[m], m) of one (t, q,
        strand) group's blocks, chunk = pair_chunk(): the counterpart of
        pack_pairs."""
        t_off, q_off, length, c_block = chunk_blocks(blocks, pair_chunk())
        tiles = np.empty((t_off.shape[0], pair_chunk()), np.int8)
        fill_scored(t_codes, q_codes, t_off, q_off, length, tiles, self.lut8)
        return tiles, c_block, tiles.shape[0]

    def chunk_scores(self, tiles: np.ndarray) -> np.ndarray:
        """(m, chunk) int8 score tiles -> int32[m] row sums; any m (the
        shards are shard_indices ranges, no padding needed)."""
        tiles = np.ascontiguousarray(tiles, np.int8)
        if tiles.ndim != 2:
            raise ValueError(f"tiles must be 2-D, got shape {tiles.shape}")
        outs = []
        for d, dev in enumerate(self.mesh):
            rows = shard_indices(tiles.shape[0], self.n_dev, d)
            if len(rows):
                PERF["dispatches"] += 1
                outs.append(_upload(tiles[rows.start:rows.stop], dev).sum(
                    dim=1, dtype=torch.int32))
        if not outs:
            return np.zeros(0, np.int32)
        return np.concatenate([_fetch(o) for o in outs])


def chain_cuts(weights, n_shards: int) -> list[int]:
    """n_shards + 1 chain indices bounding contiguous shards: the cut before
    shard i is the chain start whose prefix weight is nearest i * M / n (M
    the total; the earlier start on a tie).  Shards may be empty."""
    starts = np.concatenate([[0], np.cumsum(np.asarray(weights, np.int64))])
    cuts = [0]
    for i in range(1, n_shards):
        target = i * int(starts[-1]) / n_shards
        j = int(np.searchsorted(starts, target))
        if j > 0 and target - starts[j - 1] <= starts[j] - target:
            j -= 1
        cuts.append(max(j, cuts[-1]))
    cuts.append(len(starts) - 1)
    return cuts


class ShardedChainScorer:
    """Multi-device (global, local, aliBases) of whole chain sets, the
    contract of the reference's ShardedChainScorer (mesh.py:150-186).

    Each mesh entry holds a pair-mode TorchChainScorer (int8 tiles resident
    on its device, TorchPairChainScorer, K2 on CUDA).  The chains are cut at
    chain boundaries (chain_cuts, by chunk count); every shard's pass is
    queued before the first fetch, so separate cards overlap, and only each
    shard's (n_chains_shard, 2) int32 comes back.  OverflowError (a chain
    whose scores could leave int32) propagates, as in the reference."""

    def __init__(self, scheme, gap_calc, t_genome, q_genome, mesh=None):
        self.scheme = scheme
        self.gap_calc = gap_calc
        self.mesh = _mesh_of(mesh)
        self._shards = [TorchChainScorer(scheme, gap_calc, t_genome,
                                         q_genome, device=d, mode="pair")
                        for d in self.mesh]
        self._cuts_memo: tuple | None = None

    def cuts(self, chains: list) -> list[int]:
        """chain_cuts by chunk count; memoized for the last chain set by the
        identity of its blocks arrays, which the memo pins (as _grouped's
        memo), so scoring the same set again skips the pass over its
        blocks."""
        blocks = [c.blocks for c in chains]
        memo = self._cuts_memo
        if memo is not None and len(memo[0]) == len(blocks) and all(
                a is b for a, b in zip(memo[0], blocks)):
            return memo[1]
        chunk = self._shards[0]._dev.chunk
        weights = [int(np.maximum(-(-(b[:, 1] - b[:, 0]) // chunk), 1).sum())
                   for b in blocks]
        cuts = chain_cuts(weights, len(self._shards))
        self._cuts_memo = (blocks, cuts)
        return cuts

    def score_chains(self, chains: list) -> list[tuple[float, float, int]]:
        cuts = self.cuts(chains)
        queued = []
        for scorer, lo, hi in zip(self._shards, cuts[:-1], cuts[1:]):
            if lo == hi:
                continue
            part = chains[lo:hi]
            jobs, order = scorer._grouped(part)
            nblocks = [part[i].n_blocks for i in order]
            pcs = scorer._pair_chain()
            ali = pcs._meta(jobs, nblocks).ali
            queued.append((lo, order, ali, pcs.score_async(jobs, nblocks)))
        results: list = [None] * len(chains)
        for lo, order, ali, out in queued:
            for k, ((g, loc), a) in enumerate(zip(_fetch(out).tolist(),
                                                  ali.tolist())):
                results[lo + order[k]] = (float(g), float(loc), int(a))
        return results
