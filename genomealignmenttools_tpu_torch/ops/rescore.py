"""Batched chain rescoring on the device - the port's main path.

Counterpart of genomealignmenttools_tpu/ops/rescore.py (DeviceChainScorer,
rescore.py:282-555) in three of its modes, chosen by `mode` or GAT_RESCORE:

- `pallas` (also `auto` and unset): per-chunk score sums from K1
  (ops/window_rescore.py, csrc/rescore.cu) over genome codes resident on the
  device, and the host finishes with the native C++ combine
  `_native_combine` (rescore.py:674-710): per-block sums, gap costs and the
  global/local score scan.
- `pair`: int8 score tiles packed once on the host and kept on the device
  (ops/pair_rescore.py).  With the device combine (GAT_COMBINE=device, or
  `auto` when the same chain set is scored again), score_chains runs K2
  (ops/pair_combine.py, csrc/combine.cu: the row sums and the scans in one
  launch) on the device and fetches only (n_chains, 2) int32; otherwise the
  chunk sums (torch row sums) go to the native host combine.
- `hostnative`: no device at all (rescore.py:319-324): the threaded C++
  LUT sums straight from the host genome arrays and the native combine.
  The block scorer says `host_native = True`, so chainCleaner takes its
  native break loop and native prescore, as the reference's host run
  does.  It runs only when named (GAT_RESCORE=hostnative or
  mode="hostnative"), on the host whatever the device argument says;
  nothing chooses it and nothing falls back to it.
  It shares no code with K1, K2 or the torch scorers, which makes it the
  in-process oracle of the card runs.

chainNet -rescore scores its partial fills through `score_subsets` in
every mode: host-native runs the fused `gat_subset_scores`; the device modes
cut every fill from the chain table's arrays at once (`subset_blocks`) and
score the clipped blocks as `score_chains` scores a new chain set.
chainCleaner's prescore under the device modes takes the same call, its
Chain objects' blocks concatenated and `ChainRows` standing in for the
table.

The jax-free tail of the reference's module (`_n_threads`, `lut25_of`,
`table_row_code_ptrs`, `native_subset_scores`, `_native_combine`) is the
reference's text.  The reference's `xla` mode and its backend probing
(`auto_scorer_factory`) are not ported: the device is named, never guessed.
Results are bit-identical to engines.scoring.ChainScorer: everything is
integer math.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..device import PERF, resolve_device
from ..engines.scoring import (chain_global_score, chain_local_score,
                               gap_costs)
from ..native import get_lib
from ..utils.profiling import phase
from .window_rescore import WindowBlockScorer, upload_codes

# .pair_rescore is imported inside the functions that need it: it imports
# _n_threads from this module, as the reference's does


def _n_threads(cap: int = 16) -> int:
    """Native worker-thread count; GAT_THREADS=N overrides (1 = the
    determinism oracle, tests/test_thread_determinism.py)."""
    env = os.environ.get("GAT_THREADS")
    if env and env.isdigit() and int(env) >= 1:
        return min(int(env), cap)
    return min(os.cpu_count() or 1, cap)


RESCORE_MODES = ("auto", "pallas", "pair", "hostnative")
COMBINE_MODES = ("auto", "device", "host")

# Process-wide device-resident genome codes, shared by every
# TorchGenomeCache (as _DEV_CODES, rescore.py:159-187): the host decode is
# process-cached (device/genome.py), so the identity of a host codes array
# is stable across engine runs and keys one upload per (chrom, strand,
# device).  The host array is pinned in the entry, so a reused id() can
# never serve stale codes.  FIFO eviction by total bytes.
_DEV_CODES: dict = {}
DEV_CODES_BUDGET = 4 * 1024 ** 3


class TorchGenomeCache:
    """Per-(chrom, strand) uint8 code arrays resident on one device
    (counterpart of DeviceGenomeCache, rescore.py:190-218)."""

    def __init__(self, genome, device: torch.device):
        self.genome = genome
        self.device = device

    def codes(self, name: str, strand: str) -> torch.Tensor:
        codes = self.genome.codes(name, strand)
        key = (id(codes), str(self.device))
        hit = _DEV_CODES.get(key)
        if hit is not None and hit[0] is codes:
            return hit[1]
        total = sum(e[0].nbytes for e in _DEV_CODES.values())
        while _DEV_CODES and total + codes.nbytes > DEV_CODES_BUDGET:
            oldest = next(iter(_DEV_CODES))
            total -= _DEV_CODES.pop(oldest)[0].nbytes
        dev = upload_codes(codes, self.device)
        if self.device.type != "cpu":
            PERF["h2d_bytes"] += codes.nbytes
        _DEV_CODES[key] = (codes, dev)
        return dev


class TorchChainScorer:
    """Drop-in ChainScorer whose per-base block sums run on the device.

    Interface of DeviceChainScorer (rescore.py:282-555), and score_subsets.
    `_dev` is the window or the pair block scorer; neither is host-native, so
    chainCleaner cuts its sub-chains through score_subsets.  In mode
    `hostnative` `_dev` is the host-native pair scorer and no device is
    touched or resolved."""

    def __init__(self, scheme, gap_calc, t_genome, q_genome,
                 device: str | torch.device | None = None,
                 mode: str | None = None):
        self.scheme = scheme
        self.gap_calc = gap_calc
        self.t_genome = t_genome
        self.q_genome = q_genome
        if mode is None:
            mode = os.environ.get("GAT_RESCORE", "auto")
        if mode not in RESCORE_MODES:
            raise ValueError(
                f"GAT_RESCORE={mode!r}: the port runs {', '.join(RESCORE_MODES)}"
                "; the reference's other modes are not ported (ROADMAP.md)")
        self.mode = mode
        self.device = (torch.device("cpu") if mode == "hostnative"
                       else resolve_device(device))
        if mode in ("hostnative", "pair"):
            from .pair_rescore import TorchPairBlockScorer
        if mode == "hostnative":
            self._dev = TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                             q_genome, self.device,
                                             host_native=True)
        elif mode == "pair":
            self._dev = TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                             q_genome, self.device)
        else:
            self._dev = WindowBlockScorer(
                np.asarray(scheme.lut),
                TorchGenomeCache(t_genome, self.device),
                TorchGenomeCache(q_genome, self.device))
        self._pair_chain_scorer = None
        self._concat_cache: dict = {}
        self._repeat_workload = False

    def score_arrays(self, chain):
        bs = self._dev.block_scores(chain.t_name, chain.q_name,
                                    chain.q_strand, chain.blocks)
        return bs, gap_costs(chain.blocks, self.gap_calc)

    def global_score(self, chain) -> float:
        bs, gc = self.score_arrays(chain)
        return float(chain_global_score(bs, gc))

    def global_and_local(self, chain):
        bs, gc = self.score_arrays(chain)
        ali = int((chain.blocks[:, 1] - chain.blocks[:, 0]).sum())
        return (float(chain_global_score(bs, gc)),
                float(chain_local_score(bs, gc)), ali)

    def _grouped(self, chains: list):
        """(jobs, order): one job (t_name, q_name, strand, int64 blocks) per
        (t, q, strand) group, blocks concatenated in `order`.  The
        concatenations are memoized by the identity of the chains' blocks
        arrays, which the memo pins (rescore.py:356-391): the same chain set
        gives the same arrays, so the pair pack stays cached on the device,
        and `_repeat_workload` says so."""
        groups: dict[tuple[str, str, str], list[int]] = {}
        for i, c in enumerate(chains):
            groups.setdefault((c.t_name, c.q_name, c.q_strand), []).append(i)
        jobs = []
        order: list[int] = []
        all_hit = bool(groups)
        for (tn, qn, strand), idxs in groups.items():
            parts = [chains[i].blocks for i in idxs]
            ck = tuple(id(b) for b in parts)
            hit = self._concat_cache.get(ck)
            if hit is not None and all(a is b for a, b in zip(hit[0], parts)):
                blocks = hit[1]
            else:
                all_hit = False
                blocks = np.concatenate(parts).astype(np.int64, copy=False)
                if len(self._concat_cache) > 32:
                    self._concat_cache.clear()
                self._concat_cache[ck] = (parts, blocks)
            jobs.append((tn, qn, strand, blocks))
            order.extend(idxs)
        self._repeat_workload = all_hit
        return jobs, order

    def _device_combine(self) -> bool:
        """GAT_COMBINE: `device` or `host`; `auto` (the default) takes the
        device combine only for a chain set scored before (rescore.py:
        408-419).  Only the pair scorer has a device combine."""
        combine = os.environ.get("GAT_COMBINE", "auto")
        if combine not in COMBINE_MODES:
            raise ValueError(f"GAT_COMBINE={combine!r}: use one of "
                             f"{', '.join(COMBINE_MODES)}")
        if combine == "auto":
            combine = "device" if self._repeat_workload else "host"
        return combine == "device" and self.mode == "pair"

    def _pair_chain(self):
        if self._pair_chain_scorer is None:
            from .pair_rescore import TorchPairChainScorer
            self._pair_chain_scorer = TorchPairChainScorer(self._dev,
                                                           self.gap_calc)
        return self._pair_chain_scorer

    def score_chains(self, chains: list) -> list[tuple[float, float, int]]:
        """(global, local, aliBases) per chain, in input order, scored by
        _score_groups over the (t, q, strand) groups of _grouped."""
        jobs, order = self._grouped(chains)
        out = self._score_groups(jobs, [chains[i].n_blocks for i in order])
        results: list = [None] * len(chains)
        for k, i in enumerate(order):
            results[i] = (float(out[k, 0]), float(out[k, 1]), int(out[k, 2]))
        return results

    def _score_groups(self, jobs, counts) -> np.ndarray:
        """(n, 3) int64 [global, local, ali] of the chains that `jobs` (one
        (t_name, q_name, strand, blocks) a group) hold back to back, chain k
        with counts[k] blocks.  Pair mode with the device combine: one pass
        of chunk sums and K2 over the whole set, one (n_chains, 2) fetch;
        when a chain's scores could leave int32, the host combine below over
        the same chunk sums, counted in PERF["combine_overflow"].  Otherwise
        the chunk sums of every group, one fetch, native combine."""
        if self._device_combine():
            try:
                return np.array(self._pair_chain().score(jobs, counts),
                                np.int64).reshape(-1, 3)
            except OverflowError:
                PERF["combine_overflow"] += 1
        cs, c_block, n_blocks = self._dev.chunk_scores_multi(jobs)
        all_blocks = (np.concatenate([b for (_, _, _, b) in jobs])
                      if jobs else np.zeros((0, 4), np.int64))
        chain_off = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=chain_off[1:])
        lib = get_lib()
        if lib is not None:
            with phase("rescore: native combine"):
                return _native_combine(lib, cs, c_block, all_blocks,
                                       chain_off, self.gap_calc)
        # no native library (GAT_NATIVE=0): numpy combine per chain
        if c_block is None:     # host-native: already per-block totals
            flat = cs
        else:
            flat = np.zeros(n_blocks, np.int64)
            np.add.at(flat, c_block, cs.astype(np.int64))
        out = np.zeros((len(counts), 3), np.int64)
        for k in range(len(counts)):
            lo, hi = chain_off[k], chain_off[k + 1]
            b = all_blocks[lo:hi]
            bs = flat[lo:hi]
            gc = gap_costs(b, self.gap_calc)
            out[k] = (chain_global_score(bs, gc), chain_local_score(bs, gc),
                      int((b[:, 1] - b[:, 0]).sum()))
        return out

    def score_subsets(self, table, sel, blocks, block_off,
                      jobs) -> np.ndarray:
        """(n, 4) int64 [global, local, ali, exists] of the sub-chains that
        (row, t_lo, t_hi) jobs cut from ChainTable rows `sel` (a job's row
        indexes sel; row k's blocks are blocks[block_off[k]:block_off[k+1]]),
        without python Chain objects: the contract of native_subset_scores.
        Host-native: the fused native pass.  The device modes: subset_blocks
        cuts every job at once, and the clipped blocks are scored by
        _score_groups, grouped by their rows' (t, q, strand), as score_chains
        scores a chain set it has not scored before."""
        jobs = np.ascontiguousarray(jobs, np.int64).reshape(-1, 3)
        if self._dev.host_native:
            t_ptrs, q_ptrs, keepalive = table_row_code_ptrs(
                table, sel, self.t_genome, self.q_genome)
            out = native_subset_scores(get_lib(), blocks, block_off, t_ptrs,
                                       q_ptrs, lut25_of(self.scheme.lut),
                                       self.gap_calc, jobs)
            del keepalive
            return out
        sub, sub_off, exists = subset_blocks(blocks, block_off, jobs)
        out = np.zeros((jobs.shape[0], 4), np.int64)
        out[:, 3] = exists
        kept = np.flatnonzero(exists)
        if kept.size == 0:
            return out
        order, groups, _, chain_off = _group_by_pair(
            table, np.asarray(sel)[jobs[kept, 0]], sub,
            np.diff(sub_off)[kept])
        self._repeat_workload = False   # cut anew: never a chain set seen
        out[kept[order], :3] = self._score_groups(groups, np.diff(chain_off))
        return out

    def score_table(self, table) -> "np.ndarray | None":
        """(n, 3) float64 (global, local, aliBases) over a whole ChainTable in
        row order, without python Chain objects (rescore.py:467-519); None
        without the native library (the engine then uses score_chains)."""
        lib = get_lib()
        if lib is None:
            return None
        n = len(table)
        if n == 0:
            return np.zeros((0, 3))
        if self._dev.host_native:
            # all-host path: gat_subset_scores with full-range windows
            # scores every chain straight from the table columns
            sel = np.arange(n)
            jobs = np.stack([sel, table.header[:, 1], table.header[:, 2]],
                            axis=1)   # t_start, t_end: full cover
            return self.score_subsets(table, sel, table.blocks,
                                      table.block_offsets,
                                      jobs)[:, :3].astype(np.float64)
        order, jobs, all_blocks, chain_off = _group_by_pair(
            table, np.arange(n), table.blocks, np.diff(table.block_offsets))
        cs, c_block, _ = self._dev.chunk_scores_multi(jobs)
        with phase("rescore: native combine"):
            out = _native_combine(lib, cs, c_block, all_blocks, chain_off,
                                  self.gap_calc)
        results = np.empty((n, 3))
        results[order] = out
        return results


class ChainRows:
    """A list of Chain objects as the two members of a ChainTable that
    score_subsets reads (through _group_by_pair and table_row_code_ptrs),
    row k being chains[k]: names_factorized(), ((t_ids, t_names), (q_ids,
    q_names)) with int32 ids into each side's list of distinct names, and
    strands, uint8 ord('+') or ord('-') a row."""

    def __init__(self, chains):
        self._names = (_factorize([c.t_name for c in chains]),
                       _factorize([c.q_name for c in chains]))
        self.strands = np.array([ord(c.q_strand) for c in chains], np.uint8)

    def names_factorized(self):
        return self._names


def _factorize(values):
    """(int32 ids, distinct values in order of first appearance)."""
    idx_of: dict = {}
    ids = np.array([idx_of.setdefault(v, len(idx_of)) for v in values],
                   np.int32)
    return ids, list(idx_of)


def _group_by_pair(table, rows, blocks, counts):
    """Chains regrouped by their rows' (target, query, strand), stable within
    a group: the chains lie back to back in `blocks`, chain k with counts[k]
    blocks, of ChainTable row rows[k].  Returns (order, jobs, all_blocks,
    chain_off):
    the k-th chain in group order is chain order[k], with the blocks
    all_blocks[chain_off[k]:chain_off[k + 1]]; jobs holds the block
    scorer's (t_name, q_name, strand, blocks) of each group."""
    (t_ids, names), (q_ids, qnames) = table.names_factorized()
    t_ids, q_ids = t_ids[rows], q_ids[rows]
    minus = (table.strands[rows] == ord("-")).astype(np.int64)
    key = ((t_ids.astype(np.int64) << 33)
           | (q_ids.astype(np.int64) << 1) | minus)
    _, inverse = np.unique(key, return_inverse=True)
    order = np.argsort(inverse, kind="stable")  # rows grouped, stable
    n = order.shape[0]
    cnt_o = counts[order]
    chain_off = np.zeros(n + 1, np.int64)
    np.cumsum(cnt_o, out=chain_off[1:])
    if np.array_equal(order, np.arange(n)):
        all_blocks = np.ascontiguousarray(blocks, np.int64)
    else:
        starts = np.cumsum(counts) - counts
        pos = (np.repeat(starts[order] - chain_off[:-1], cnt_o)
               + np.arange(int(chain_off[-1])))
        all_blocks = np.ascontiguousarray(blocks[pos], np.int64)
    ginv = inverse[order]
    gstart = np.flatnonzero(np.r_[True, ginv[1:] != ginv[:-1]])
    gend = np.r_[gstart[1:], n]
    jobs = []
    for s, e in zip(gstart.tolist(), gend.tolist()):
        i = int(order[s])
        jobs.append((names[t_ids[i]], qnames[q_ids[i]],
                     "-" if minus[i] else "+",
                     all_blocks[chain_off[s]:chain_off[e]]))
    return order, jobs, all_blocks, chain_off


def subset_blocks(blocks, block_off, jobs):
    """chainSubsetOnT (Chain.subset_on_t) for every (row, t_lo, t_hi) job
    at once, row k's blocks being blocks[block_off[k]:block_off[k + 1]],
    t-sorted.  A job keeps the blocks with tEnd > t_lo and tStart < t_hi;
    its first block's tStart and qStart move up to t_lo, its last block's
    tEnd and qEnd down to t_hi.  Returns (sub, sub_off, exists): job k's
    clipped blocks are sub[sub_off[k]:sub_off[k + 1]], (m, 4) int64, and
    exists[k] says it kept any.  Coordinates are non-negative."""
    with phase("rescore: cut subsets"):
        blocks = np.asarray(blocks, np.int64)
        block_off = np.asarray(block_off, np.int64)
        jobs = np.asarray(jobs, np.int64).reshape(-1, 3)
        n = jobs.shape[0]
        sub_off = np.zeros(n + 1, np.int64)
        if n == 0 or blocks.shape[0] == 0:
            return np.zeros((0, 4), np.int64), sub_off, np.zeros(n, bool)
        row, lo, hi = jobs[:, 0], jobs[:, 1], jobs[:, 2]
        # keyed by (its row, a coordinate), every block of every row is in
        # one sorted order: one search per bound finds each job's range
        span = int(max(blocks[:, 1].max(), lo.max(), hi.max())) + 1
        base = np.repeat(np.arange(block_off.shape[0] - 1, dtype=np.int64)
                         * span, np.diff(block_off))
        first = np.searchsorted(base + blocks[:, 1], row * span + lo, "right")
        last = np.searchsorted(base + blocks[:, 0], row * span + hi, "left")
        cnt = np.maximum(last - first, 0)
        exists = cnt > 0
        np.cumsum(cnt, out=sub_off[1:])
        pos = (np.repeat(first - sub_off[:-1], cnt)
               + np.arange(int(sub_off[-1])))
        sub = blocks[pos]
        head, tail = sub_off[:-1][exists], sub_off[1:][exists] - 1
        d = np.maximum(lo[exists] - sub[head, 0], 0)
        sub[head, 0] += d
        sub[head, 2] += d
        d = np.maximum(sub[tail, 1] - hi[exists], 0)
        sub[tail, 1] -= d
        sub[tail, 3] -= d
    return sub, sub_off, exists


def torch_scorer_factory(device: str | torch.device | None = None,
                         mode: str | None = None):
    """Engine-side scorer factory (the `scorer_factory` argument of
    score_chain_file, chain_net and clean_chains): TorchChainScorer on
    `device` in `mode` (None: GAT_RESCORE).  Counterpart of
    auto_scorer_factory (rescore.py:558-593), without its backend probing:
    the device is named, never guessed.  The host-native mode resolves no
    device: it runs on the host whatever `device` says."""
    if (mode or os.environ.get("GAT_RESCORE", "auto")) != "hostnative":
        device = resolve_device(device)
    return functools.partial(TorchChainScorer, device=device, mode=mode)


def lut25_of(scheme_lut) -> np.ndarray:
    """Flat 5x5 int32 LUT indexed [q*5+t] (native scoring layout)."""
    lut25 = np.zeros(25, np.int32)
    lut = np.asarray(scheme_lut)
    for qv in range(min(5, lut.shape[0])):
        for tv in range(min(5, lut.shape[1])):
            lut25[qv * 5 + tv] = lut[qv, tv]
    return lut25


def table_row_code_ptrs(table, sel, t_genome, q_genome):
    """Per-row genome code pointers for ChainTable rows `sel`.

    Returns (t_ptrs, q_ptrs, keepalive): ctypes pointer arrays indexed by
    position within sel, plus the list of arrays that must stay alive for
    the duration of the native call."""
    import ctypes
    (t_ids, names), (q_ids, qnames) = table.names_factorized()
    t_ids = t_ids[sel]
    q_ids = q_ids[sel]
    minus = table.strands[sel] == ord("-")
    t_arrs = {j: np.ascontiguousarray(t_genome.codes(names[j], "+"))
              for j in set(t_ids.tolist())}
    q_plus, q_minus = {}, {}
    for j in set(q_ids.tolist()):
        rows_j = q_ids == j
        if (rows_j & ~minus).any():
            q_plus[j] = np.ascontiguousarray(q_genome.codes(qnames[j], "+"))
        if (rows_j & minus).any():
            q_minus[j] = np.ascontiguousarray(q_genome.codes(qnames[j], "-"))
    n = int(sel.shape[0])
    t_ptrs = (ctypes.c_void_p * n)()
    q_ptrs = (ctypes.c_void_p * n)()
    t_ptr_of = {j: a.ctypes.data for j, a in t_arrs.items()}
    qp_ptr = {j: a.ctypes.data for j, a in q_plus.items()}
    qm_ptr = {j: a.ctypes.data for j, a in q_minus.items()}
    mlist = minus.tolist()
    qlist = q_ids.tolist()
    for i, tj in enumerate(t_ids.tolist()):
        t_ptrs[i] = t_ptr_of[tj]
        q_ptrs[i] = qm_ptr[qlist[i]] if mlist[i] else qp_ptr[qlist[i]]
    keepalive = (list(t_arrs.values()) + list(q_plus.values())
                 + list(q_minus.values()))
    return t_ptrs, q_ptrs, keepalive


def native_subset_scores(lib, blocks, chain_off, t_ptrs, q_ptrs, lut25,
                         gap_calc, jobs_arr) -> np.ndarray:
    """gat_subset_scores: fused chainSubsetOnT + scoring over (row, t_lo,
    t_hi) jobs; returns (n_jobs, 4) int64 [global, local, ali, exists]."""
    import ctypes
    blocks = np.ascontiguousarray(blocks, np.int64)
    chain_off = np.ascontiguousarray(chain_off, np.int64)
    jobs_arr = np.ascontiguousarray(jobs_arr, np.int64)
    lut25 = np.ascontiguousarray(lut25, np.int32)
    out = np.empty((jobs_arr.shape[0], 4), np.int64)
    gc = gap_calc
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gat_subset_scores(
        blocks.ctypes.data_as(i64p), chain_off.ctypes.data_as(i64p),
        chain_off.shape[0] - 1, t_ptrs, q_ptrs,
        lut25.ctypes.data_as(i32p),
        jobs_arr.ctypes.data_as(i64p), jobs_arr.shape[0],
        int(gc.small_size),
        gc.q_small.ctypes.data_as(i64p),
        gc.t_small.ctypes.data_as(i64p),
        gc.b_small.ctypes.data_as(i64p),
        gc.long_pos.ctypes.data_as(i64p), int(gc.long_pos.shape[0]),
        np.ascontiguousarray(gc.q_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.t_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.b_long).ctypes.data_as(f64p),
        out.ctypes.data_as(i64p),
        _n_threads())
    return out


def _native_combine(lib, chunk_scores: np.ndarray, c_block: np.ndarray,
                    blocks: np.ndarray, chain_off: np.ndarray, gap_calc):
    """Call gat_combine_scores; returns (n_chains, 3) int64
    [global, local, ali]."""
    import ctypes
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n_chains = chain_off.shape[0] - 1
    n_blocks = blocks.shape[0]
    out = np.zeros((n_chains, 3), np.int64)
    if c_block is None:
        # chunk_scores already ARE the per-block totals (fused direct
        # host scoring); skip the segment-sum stage entirely
        bs_out = np.ascontiguousarray(chunk_scores, np.int64)
        chunk_scores = np.zeros(0, np.int32)
        c_block = np.zeros(0, np.int64)
    else:
        bs_out = np.zeros(n_blocks, np.int64)
        chunk_scores = np.ascontiguousarray(chunk_scores, np.int32)
        c_block = np.ascontiguousarray(c_block, np.int64)
    gc = gap_calc
    lib.gat_combine_scores(
        chunk_scores.ctypes.data_as(i32p), c_block.ctypes.data_as(i64p),
        chunk_scores.shape[0],
        blocks.ctypes.data_as(i64p), chain_off.ctypes.data_as(i64p),
        n_chains,
        int(gc.small_size),
        gc.q_small.ctypes.data_as(i64p), gc.t_small.ctypes.data_as(i64p),
        gc.b_small.ctypes.data_as(i64p),
        gc.long_pos.ctypes.data_as(i64p), gc.long_pos.shape[0],
        np.ascontiguousarray(gc.q_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.t_long).ctypes.data_as(f64p),
        np.ascontiguousarray(gc.b_long).ctypes.data_as(f64p),
        bs_out.ctypes.data_as(i64p),
        out.ctypes.data_as(i64p))
    return out
