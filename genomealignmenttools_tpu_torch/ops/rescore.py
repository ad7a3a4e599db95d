"""Batched chain rescoring on the device - the port's main path.

Counterpart of genomealignmenttools_tpu/ops/rescore.py (DeviceChainScorer,
rescore.py:282-555) in two of its modes, chosen by `mode` or GAT_RESCORE:

- `pallas` (also `auto` and unset): per-chunk score sums from K1
  (ops/window_rescore.py, csrc/rescore.cu) over genome codes resident on the
  device, and the host finishes with the native C++ combine
  `_native_combine` (rescore.py:674-710): per-block sums, gap costs and the
  global/local score scan.
- `pair`: int8 score tiles packed once on the host and kept on the device
  (ops/pair_rescore.py).  With the device combine (GAT_COMBINE=device, or
  `auto` when the same chain set is scored again), score_chains runs the
  chunk sums and K2 (ops/pair_combine.py, csrc/combine.cu) on the device and
  fetches only (n_chains, 2) int32; otherwise the chunk sums go to the
  native host combine.

The jax-free helpers of the reference (`_native_combine`) are imported as
they are; `DeviceChainScorer` is not, since its `score_chains` imports
ops/pair_rescore.py and with it jax.  Results are bit-identical to
engines.scoring.ChainScorer: everything is integer math.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from genomealignmenttools_tpu.engines.scoring import (chain_global_score,
                                                      chain_local_score,
                                                      gap_costs)
from genomealignmenttools_tpu.native import get_lib
from genomealignmenttools_tpu.ops.rescore import _native_combine
from genomealignmenttools_tpu.utils.profiling import phase

from ..device import PERF, resolve_device
from .pair_rescore import TorchPairBlockScorer, TorchPairChainScorer
from .window_rescore import WindowBlockScorer

RESCORE_MODES = ("auto", "pallas", "pair")
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
        dev = torch.from_numpy(np.ascontiguousarray(codes)).to(self.device)
        if self.device.type != "cpu":
            PERF["h2d_bytes"] += codes.nbytes
        _DEV_CODES[key] = (codes, dev)
        return dev


class TorchChainScorer:
    """Drop-in ChainScorer whose per-base block sums run on the device.

    Interface of DeviceChainScorer (rescore.py:282-555).  `_dev` is the
    window or the pair block scorer; neither is host-native, so chainCleaner
    and chainNet -rescore batch their sub-chains through score_chains."""

    def __init__(self, scheme, gap_calc, t_genome, q_genome,
                 device: str | torch.device | None = None,
                 mode: str | None = None):
        self.scheme = scheme
        self.gap_calc = gap_calc
        self.t_genome = t_genome
        self.q_genome = q_genome
        self.device = resolve_device(device)
        if mode is None:
            mode = os.environ.get("GAT_RESCORE", "auto")
        if mode not in RESCORE_MODES:
            raise ValueError(
                f"GAT_RESCORE={mode!r}: the port runs {', '.join(RESCORE_MODES)}"
                "; the reference's other modes are not ported (ROADMAP.md)")
        self.mode = mode
        if mode == "pair":
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

    def _pair_chain(self) -> TorchPairChainScorer:
        if self._pair_chain_scorer is None:
            self._pair_chain_scorer = TorchPairChainScorer(self._dev,
                                                           self.gap_calc)
        return self._pair_chain_scorer

    def score_chains(self, chains: list) -> list[tuple[float, float, int]]:
        """(global, local, aliBases) per chain, in input order.  Pair mode
        with the device combine: one pass of chunk sums and K2 over the whole
        set, one (n_chains, 2) fetch; when a chain's scores could leave
        int32, the host combine below over the same chunk sums, counted in
        PERF["combine_overflow"].  Otherwise the chunk sums of every
        (t, q, strand) group, one fetch, native combine."""
        jobs, order = self._grouped(chains)
        results: list = [None] * len(chains)
        if self._device_combine():
            try:
                scored = self._pair_chain().score(
                    jobs, [chains[i].n_blocks for i in order])
            except OverflowError:
                PERF["combine_overflow"] += 1
            else:
                for k, i in enumerate(order):
                    results[i] = scored[k]
                return results
        cs, c_block, n_blocks = self._dev.chunk_scores_multi(jobs)
        lib = get_lib()
        if lib is not None:
            all_blocks = (np.concatenate([b for (_, _, _, b) in jobs])
                          if jobs else np.zeros((0, 4), np.int64))
            chain_off = np.zeros(len(order) + 1, np.int64)
            np.cumsum([chains[i].n_blocks for i in order],
                      out=chain_off[1:])
            with phase("rescore: native combine"):
                out = _native_combine(lib, cs, c_block, all_blocks,
                                      chain_off, self.gap_calc)
            for k, i in enumerate(order):
                results[i] = (float(out[k, 0]), float(out[k, 1]),
                              int(out[k, 2]))
            return results
        # no native library (GAT_NATIVE=0): numpy combine per chain
        flat = np.zeros(n_blocks, np.int64)
        np.add.at(flat, c_block, cs.astype(np.int64))
        off = 0
        for i in order:
            c = chains[i]
            bs = flat[off:off + c.n_blocks]
            off += c.n_blocks
            gc = gap_costs(c.blocks, self.gap_calc)
            results[i] = (float(chain_global_score(bs, gc)),
                          float(chain_local_score(bs, gc)),
                          int((c.blocks[:, 1] - c.blocks[:, 0]).sum()))
        return results

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
        (t_ids, names), (q_ids, qnames) = table.names_factorized()
        minus = (table.strands == ord("-")).astype(np.int64)
        key = ((t_ids.astype(np.int64) << 33)
               | (q_ids.astype(np.int64) << 1) | minus)
        _, inverse = np.unique(key, return_inverse=True)
        order = np.argsort(inverse, kind="stable")  # rows grouped, stable
        bo = table.block_offsets
        cnt_o = (bo[1:] - bo[:-1])[order]
        chain_off = np.zeros(n + 1, np.int64)
        np.cumsum(cnt_o, out=chain_off[1:])
        if np.array_equal(order, np.arange(n)):
            all_blocks = np.ascontiguousarray(table.blocks, np.int64)
        else:
            pos = (np.repeat(bo[order] - chain_off[:-1], cnt_o)
                   + np.arange(int(chain_off[-1])))
            all_blocks = np.ascontiguousarray(table.blocks[pos], np.int64)
        ginv = inverse[order]
        gstart = np.flatnonzero(np.r_[True, ginv[1:] != ginv[:-1]])
        gend = np.r_[gstart[1:], n]
        jobs = []
        for s, e in zip(gstart.tolist(), gend.tolist()):
            i = int(order[s])
            jobs.append((names[t_ids[i]], qnames[q_ids[i]],
                         "-" if minus[i] else "+",
                         all_blocks[chain_off[s]:chain_off[e]]))
        cs, c_block, _ = self._dev.chunk_scores_multi(jobs)
        with phase("rescore: native combine"):
            out = _native_combine(lib, cs, c_block, all_blocks, chain_off,
                                  self.gap_calc)
        results = np.empty((n, 3))
        results[order] = out
        return results


def torch_scorer_factory(device: str | torch.device | None = None,
                         mode: str | None = None):
    """Engine-side scorer factory (the `scorer_factory` argument of
    score_chain_file, chain_net and clean_chains): TorchChainScorer on
    `device` in `mode` (None: GAT_RESCORE).  Counterpart of
    auto_scorer_factory (rescore.py:558-593), without its backend probing:
    the device is named, never guessed."""
    return functools.partial(TorchChainScorer, device=resolve_device(device),
                             mode=mode)
