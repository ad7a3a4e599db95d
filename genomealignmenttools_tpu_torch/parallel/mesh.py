"""Device lists and sharded batched rescoring.

Counterpart of genomealignmenttools_tpu/parallel/mesh.py.  A mesh is a tuple
of torch.devices; an entry may repeat (["cuda:0"] * 4 on a one-card machine,
["cpu"] * 8 in the tests), and each entry is one shard.

    ShardedBlockScorer   per-block scores; blocks cut into contiguous
                         equal-count shards (mesh.py:63-97), each run through
                         K1 (CPU: its plain version) over genome codes
                         replicated on its device
    ShardedPairScorer    chunk sums of the reference's combined-code tiles
                         (pack_pairs), cut into contiguous row shards
                         (mesh.py:127-147)
    ShardedChainScorer   (global, local, aliBases) of whole chain sets; the
                         chains are cut into contiguous shards at chain
                         boundaries, each a whole pair scorer with K2 on its
                         device (mesh.py:150-186)

Why ShardedChainScorer cuts at chain boundaries: the JAX version row-shards
the tiles evenly and lets GSPMD insert the combine's cross-shard carries;
torch has no GSPMD.  A chain's scores depend only on its own chunks, so a
shard that holds whole chains needs no carry at all: it runs K2 (row sums
and scans in one launch) and the finish alone, and only the (n_chains_shard, 2) results are
gathered.  The cut before shard i is the chain start nearest i * M / n,
where M is the chunk count of the set (chain_cuts), so shards are balanced
by chunks (aligned bases) as far as whole chains allow.  Outputs do not
depend on where the cuts fall.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import PERF, resolve_device
from ..ops.pair_combine import tile_row_sums
from ..ops.pair_rescore import lut8_of
from ..ops.rescore import TorchChainScorer
from ..ops.window_rescore import (checked_lut, chunk_blocks, chunk_sums,
                                  upload_codes)
from .distributed import shard_indices


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
        if device.type != "cpu":
            PERF["h2d_bytes"] += codes.nbytes
        dev_codes = upload_codes(codes, device)
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
    """Multi-device chunk sums of combined-code tiles (a byte q * 5 + t a
    base, pad 24), the tiles of the reference's pack_pairs and of the port's
    (ops/pair_rescore.py), cut into contiguous row shards.  Each shard is
    decoded with torch ops on its device (tile_row_sums, the counterpart of
    the XLA _sharded_pair_scores, mesh.py:107-124).  Tiles are
    genome-agnostic: no genome is replicated.  The matrix must fit int8 with
    a zero N row and column, as the reference's pack_lut asserts."""

    def __init__(self, lut: np.ndarray, mesh=None):
        self.mesh = _mesh_of(mesh)
        self.table = torch.from_numpy(lut8_of(lut))
        self.n_dev = len(self.mesh)

    def chunk_scores(self, c8: np.ndarray) -> np.ndarray:
        """(m, chunk) uint8 combined-code tiles -> int32[m] chunk scores; any
        m (the shards are shard_indices ranges, no padding needed)."""
        c8 = np.ascontiguousarray(c8, np.uint8)
        if c8.ndim != 2:
            raise ValueError(f"tiles must be 2-D, got shape {c8.shape}")
        outs = []
        for d, dev in enumerate(self.mesh):
            rows = shard_indices(c8.shape[0], self.n_dev, d)
            if len(rows):
                PERF["dispatches"] += 1
                outs.append(tile_row_sums(
                    _upload(c8[rows.start:rows.stop], dev), "code",
                    self.table))
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

    Each mesh entry holds a pair-mode TorchChainScorer (tiles resident on
    its device in the format GAT_PAIR_TILES names, TorchPairChainScorer, the
    format's K2 entry on CUDA).  The chains are cut at
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
