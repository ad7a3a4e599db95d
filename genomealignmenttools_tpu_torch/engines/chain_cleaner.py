"""chainCleaner engine: remove chain-breaking alignments ("suspects").

Behavioral reference: src/chainCleaner/chainCleaner.c.  Pipeline:

1. net the chains in-process if no net given (chainNet -minScore=0 |
   NetFilterNonNested -minScore1 3000; chainCleaner.c:1639-1668)
2. walk the net: every depth>1 fill records (fill, enclosing gap, parent
   chain) - parseFill (786-860); chains seen >1 time yield break candidates
   from consecutive fill pairs - getValidBreaks (969-1079), filtered by
   isBrokenByAnotherHigherScoringChain (868-885) against a merged interval
   tree of net aligning blocks
3. read chains; pass through all that are neither breaking nor broken
   (readChainsOfInterest 584-618)
4. fixed-point suspect removal per breaking chain - loopOverBreaks
   (1452-1631) + testAndRemoveSuspect (1191-1398): score 4 sub-chains
   (suspect + left/right/whole fill of the broken chain), apply ratio and
   threshold tests, remove passing suspects from the breaking chain and
   emit them as new chains + BED records
5. rescore modified chains, write, chainSort (score desc)

Output byte-parity requires kent hash-table iteration order (see
utils/kenthash.py): break processing follows hashElListHash(breakHash)
(reverse kent traversal), final chain-of-interest writes follow
hashTraverseEls(chainId2IsOfInterest), and suspect/BED emission order
follows the removal sequence.

All sub-chain scoring goes through a ChainScorer (host numpy or batched
device path).
"""

from __future__ import annotations

import io
import os
import sys
from bisect import bisect_left, insort
from dataclasses import dataclass

import numpy as np

from ..device import PERF
from ..device.genome import open_genome
from ..formats.chain import Chain, format_score, iter_chains
from ..formats.gapcalc import gap_calc_from_file
from ..formats.net import NetFill, read_nets
from ..formats.scorematrix import read_score_scheme, score_scheme_default
from ..utils.kenthash import KentHash
from ..utils.profiling import phase
from .chain_net import chain_net
from .net_filter_nonnested import net_filter_non_nested
from .scoring import ChainScorer, chain_global_score, chain_local_score

INT_MAX = 2 ** 31 - 1


@dataclass
class FillGapInfo:
    depth: int
    chain_id: int
    chrom: str
    fill_start: int
    fill_end: int
    gap_start: int = 0
    gap_end: int = 0
    parent_chain_id: int = 0
    gap_depth: int = 0


class BreakInfo:
    __slots__ = ("depth", "chain_id", "parent_chain_id", "chrom",
                 "l_fill_start", "l_fill_end", "r_fill_start", "r_fill_end",
                 "l_gap_start", "l_gap_end", "r_gap_start", "r_gap_end",
                 "suspect_start", "suspect_end")

    def __init__(self, depth, chain_id, parent_chain_id, chrom,
                 lfs, lfe, rfs, rfe, lgs, lge, rgs, rge):
        self.depth = depth
        self.chain_id = chain_id
        self.parent_chain_id = parent_chain_id
        self.chrom = chrom
        self.l_fill_start, self.l_fill_end = lfs, lfe
        self.r_fill_start, self.r_fill_end = rfs, rfe
        self.l_gap_start, self.l_gap_end = lgs, lge
        self.r_gap_start, self.r_gap_end = rgs, rge
        self.suspect_start = lge
        self.suspect_end = rgs
        assert self.suspect_start < self.suspect_end
        assert self.l_fill_start < self.suspect_start
        assert self.l_fill_end <= self.suspect_start
        assert self.r_fill_start >= self.suspect_end
        assert self.r_fill_end > self.suspect_end


class _MergedRanges:
    """genomeRangeTree emulation: per-chrom strictly-overlap-merged ranges
    carrying lists of chain ids (genomeRangeTreeAddValList semantics)."""

    def __init__(self):
        self.raw: dict[str, list[tuple[int, int, int]]] = {}
        self.merged: dict[str, tuple[np.ndarray, np.ndarray, list[list[int]]]] = {}

    def add(self, chrom: str, start: int, end: int, chain_id: int):
        self.raw.setdefault(chrom, []).append((start, end, chain_id))

    def build(self):
        for chrom, items in self.raw.items():
            items = sorted(items, key=lambda x: (x[0], x[1]))
            starts, ends, vals = [], [], []
            for s, e, cid in items:
                if starts and s < ends[-1]:  # strict overlap merges
                    ends[-1] = max(ends[-1], e)
                    vals[-1].append(cid)
                else:
                    starts.append(s)
                    ends.append(e)
                    vals.append([cid])
            self.merged[chrom] = (np.array(starts, np.int64),
                                  np.array(ends, np.int64), vals)

    def overlapping_ids(self, chrom: str, start: int, end: int) -> list[int]:
        if chrom not in self.merged:
            return []
        starts, ends, vals = self.merged[chrom]
        lo = int(np.searchsorted(ends, start, side="right"))
        hi = int(np.searchsorted(starts, end, side="left"))
        out: list[int] = []
        for i in range(lo, hi):
            out.extend(vals[i])
        return out


def _parse_fill_walk(net_name: str, fills: list[NetFill], depth: int,
                     depth2gap: dict, depth2chain: dict,
                     chain_id_count: KentHash, fill_gap_lists: KentHash):
    """parseFill (chainCleaner.c:786-860), linear walk of the net tree."""
    for fill in fills:
        if fill.is_fill:
            depth2chain[depth] = fill.chain_id
            if depth > 1:
                key = str(fill.chain_id)
                cnt = chain_id_count.lookup(key)
                if cnt is None:
                    chain_id_count.add(key, 1)
                else:
                    # hashIncInt updates in place (no re-add)
                    chain_id_count.update(key, cnt + 1)
                g_chrom, g_start, g_end, g_parent, g_depth = depth2gap[depth - 1]
                fg = FillGapInfo(
                    depth=depth, chain_id=fill.chain_id, chrom=net_name,
                    fill_start=fill.t_start, fill_end=fill.t_end,
                    gap_start=g_start, gap_end=g_end,
                    parent_chain_id=g_parent, gap_depth=g_depth)
                lst = fill_gap_lists.lookup(key)
                if lst is None:
                    fill_gap_lists.add(key, [fg])
                else:
                    lst.append(fg)
        else:
            depth2gap[depth] = (net_name, fill.t_start, fill.t_end,
                                depth2chain[depth - 1], depth)
        if fill.children:
            _parse_fill_walk(net_name, fill.children, depth + 1, depth2gap,
                             depth2chain, chain_id_count, fill_gap_lists)


def _add_ali_blocks(tree: _MergedRanges, fill: NetFill, t_name: str):
    """addAliBlocksToGenomeRangeTree (chainCleaner.c:718-737)."""
    t_start = fill.t_start
    children = fill.children
    i = 0
    while True:
        # nextGapWithInsert: next child (gap) having children
        j = None
        for k in range(i, len(children)):
            if children[k].children:
                j = k
                break
        if j is None:
            break
        child = children[j]
        tree.add(t_name, t_start, child.t_start, fill.chain_id)
        t_start = child.t_start + child.t_size
        i = j + 1
    tree.add(t_name, t_start, fill.t_start + fill.t_size, fill.chain_id)


def _r_convert(tree: _MergedRanges, fills: list[NetFill], t_name: str):
    for fill in fills:
        if fill.chain_id:
            _add_ali_blocks(tree, fill, t_name)
        if fill.children:
            _r_convert(tree, fill.children, t_name)


class ChainCleaner:
    def __init__(self, scorer: ChainScorer,
                 lr_fold_threshold: float = 2.5,
                 fold_threshold: float = 0.0,
                 max_suspect_bases: float = float(INT_MAX),
                 max_suspect_score: float = 100000.0,
                 min_broken_chain_score: float = 50000.0,
                 min_lr_gap_size: int = 0,
                 do_pairs: bool = False,
                 lr_fold_threshold_pairs: float = 10.0,
                 max_pair_distance: int = 10000,
                 host_scorer: ChainScorer | None = None,
                 only_this_chr: str | None = None,
                 only_this_start: int = -1,
                 only_this_end: int = -1,
                 suspect_data_out=None,
                 debug_out: dict | None = None):
        self.scorer = scorer
        # host scorer for cache-miss stragglers (bit-identical to the
        # device path); defaults to the main scorer
        self.host_scorer = host_scorer or scorer
        self.lr_fold = lr_fold_threshold
        self.fold = fold_threshold
        self.max_suspect_bases = max_suspect_bases
        self.max_suspect_score = max_suspect_score
        self.min_broken_score = min_broken_chain_score
        self.min_lr_gap = min_lr_gap_size
        self.do_pairs = do_pairs
        self.lr_fold_pairs = lr_fold_threshold_pairs
        self.max_pair_distance = max_pair_distance
        # debug/introspection surface (chainCleaner.c:248-270):
        # -onlyThisChr/-onlyThisStart/-onlyThisEnd restrict netting walk +
        # break pairing to one suspect region; -suspectDataFile dumps every
        # tested break's data and suppresses all removals (doPairs forced
        # off by the caller, chainCleaner.c:1831-1832); -debug writes the 4
        # sub-chains + suspect/fill bed per test (chainCleaner.c:1312-1321)
        self.only_this_chr = only_this_chr
        self.only_this_start = only_this_start
        self.only_this_end = only_this_end
        self.suspect_data_out = suspect_data_out
        self._suspect_id = 0
        self.debug_out = debug_out or {}
        self._debug_info = ""

        self.chain_of_interest = KentHash()  # chainId2IsOfInterest
        self.needs_rescoring = KentHash()
        self.break_hash = KentHash()  # parentChainId -> list[BreakInfo]
        self.chains: dict[int, Chain] = {}  # chainId2chain
        self.max_chain_id = -1
        self.bed_lines: list[str] = []
        self.suspect_chains: list[Chain] = []
        self.new_id_dict: list[tuple[int, int]] = []

        # sub-chain score cache: (chain_id, t_start, t_end) ->
        # (global, local, ali_bases, exists, seq).  A cached entry is valid
        # unless a later block removal on that chain overlaps its t-range
        # (chainRemoveBlocks only deletes blocks inside the removed suspect
        # range, so scores over disjoint ranges are unaffected).  This lets
        # one batched device round trip score every pending break's 4
        # sub-chains up front while the fixed-point removal loop replays the
        # reference's strictly sequential decisions (chainCleaner.c:1452-1631)
        # byte-exactly on host.
        self._sub_cache: dict[tuple[int, int, int], tuple] = {}
        self._removed_ranges: dict[int, list[tuple[int, int, int]]] = {}
        self._seq = 0
        self._cache_misses = 0

    # ------------------------------------------------------------------
    def find_breaks(self, nets) -> None:
        """getFillGapAndValidBreaks (chainCleaner.c:1088-1169)."""
        chain_id_count = KentHash()
        fill_gap_lists = KentHash()
        for net in nets:
            # -onlyThisChr skips whole nets in both walks
            # (chainCleaner.c:1118, 1132)
            if self.only_this_chr is not None \
                    and net.name != self.only_this_chr:
                continue
            depth2gap: dict[int, tuple] = {}
            depth2chain: dict[int, int] = {}
            _parse_fill_walk(net.name, net.fills, 1, depth2gap, depth2chain,
                             chain_id_count, fill_gap_lists)

        tree = _MergedRanges()
        for net in nets:
            if self.only_this_chr is not None \
                    and net.name != self.only_this_chr:
                continue
            _r_convert(tree, net.fills, net.name)
        tree.build()
        self._valid_breaks(chain_id_count, fill_gap_lists, tree)

    def _replay_break_rows(self, recs, names) -> None:
        """Replay native break records (GatBreaks rows) into the
        kent-ordered break/interest hashes."""
        for row in recs.tolist():
            (depth, cid, parent, net_idx, lfs, lfe, rfs, rfe,
             lgs, lge, rgs, rge) = row
            brk = BreakInfo(depth, cid, parent, names[net_idx],
                            lfs, lfe, rfs, rfe, lgs, lge, rgs, rge)
            self._hash_add_true(self.chain_of_interest, cid)
            self._hash_add_true(self.chain_of_interest, parent)
            pkey = str(parent)
            lst = self.break_hash.lookup(pkey)
            if lst is None:
                self.break_hash.add(pkey, [brk])
            else:
                lst.append(brk)

    def find_breaks_sweep(self, nt, min_score1: int = 3000) -> bool:
        """Fused break finding straight off the native sweep's node
        arrays (netscan.cpp gat_breaks_from_sweep): the net writer's
        subchainInfo/pruning, the NetFilterNonNested two-set splice and
        the break core all run in C++ with no net text in between.
        Byte-equivalent to write -> filter -> find_breaks_text (asserted
        by tests/test_chain_cleaner_parity.py).  Returns False when the
        native entry point is unavailable."""
        if self.only_this_chr is not None:
            return False
        from ..native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "gat_breaks_from_sweep"):
            return False
        import ctypes
        blocks, block_off, headers, _strands, ids, scores = \
            nt._chain_arrays()
        nodes = np.ascontiguousarray(nt.nodes_t, np.int64)
        segs = np.ascontiguousarray(nt.segs_t, np.int64)
        off = np.zeros(len(nt.t_names) + 1, np.int64)
        parts = []
        for i, nm in enumerate(nt.t_names):
            b = nm.encode()
            parts.append(b)
            off[i + 1] = off[i] + len(b)
        chrom_blob = b"".join(parts)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        int_max = 2 ** 31 - 1
        res_p = lib.gat_breaks_from_sweep(
            nodes.ctypes.data_as(i64p), nodes.shape[0],
            segs.ctypes.data_as(i64p), segs.shape[0],
            chrom_blob, off.ctypes.data_as(i64p),
            headers.ctypes.data_as(i64p),
            blocks.ctypes.data_as(i64p), block_off.ctypes.data_as(i64p),
            len(ids),
            ids.ctypes.data_as(i64p), scores.ctypes.data_as(f64p),
            float(nt.min_score), int(nt.min_fill),
            min_score1, 0, 0, int_max, int_max, int_max)
        try:
            res = res_p.contents
            err = bytes(res.error).split(b"\0")[0]
            if err:
                raise ValueError(err.decode())
            blob = ctypes.string_at(res.name_blob,
                                    res.name_off[res.n_nets])
            names = [blob[res.name_off[i]:res.name_off[i + 1]].decode()
                     for i in range(res.n_nets)]
            if res.n_breaks:
                recs = np.ctypeslib.as_array(
                    res.breaks, shape=(res.n_breaks, 12)).copy()
            else:
                recs = np.zeros((0, 12), np.int64)
        finally:
            lib.gat_find_breaks_free(res_p)
        self._replay_break_rows(recs, names)
        return True

    def find_breaks_text(self, net_text: bytes) -> bool:
        """find_breaks over the native break finder (native/netscan.cpp
        gat_find_breaks): the whole parseFill walk, genomeRangeTree build
        and getValidBreaks loop run in C++; python only replays the
        accepted break records into the kent-ordered hashes.  Returns
        False when the native library is unavailable (caller falls back
        to read_nets)."""
        if self.only_this_chr is not None:
            # the onlyThis* filters live in the python walk
            return False
        from ..native import get_lib
        lib = get_lib()
        if lib is None:
            return False
        import ctypes
        if isinstance(net_text, (bytes, bytearray)):
            buf = net_text
        else:  # memoryview from filter_net_bytes: zero-copy ctypes view
            mv = memoryview(net_text)
            buf = (ctypes.c_char * mv.nbytes).from_buffer(mv)
        if hasattr(lib, "gat_find_breaks"):
            res_p = lib.gat_find_breaks(buf, len(net_text))
            try:
                res = res_p.contents
                err = bytes(res.error).split(b"\0")[0]
                if err:
                    raise ValueError(err.decode())
                blob = ctypes.string_at(res.name_blob,
                                        res.name_off[res.n_nets])
                names = [blob[res.name_off[i]:res.name_off[i + 1]].decode()
                         for i in range(res.n_nets)]
                if res.n_breaks:
                    recs = np.ctypeslib.as_array(
                        res.breaks, shape=(res.n_breaks, 12)).copy()
                else:
                    recs = np.zeros((0, 12), np.int64)
            finally:
                lib.gat_find_breaks_free(res_p)
            self._replay_break_rows(recs, names)
            return True
        res_p = lib.gat_net_scan(buf, len(net_text))
        try:
            res = res_p.contents
            err = bytes(res.error).split(b"\0")[0]
            if err:
                raise ValueError(err.decode())
            import ctypes
            blob = ctypes.string_at(res.name_blob,
                                    res.name_off[res.n_nets])
            names = [blob[res.name_off[i]:res.name_off[i + 1]].decode()
                     for i in range(res.n_nets)]
            if res.n_nodes:
                nodes = np.ctypeslib.as_array(
                    res.nodes, shape=(res.n_nodes, 5)).tolist()
            else:
                nodes = []
        finally:
            lib.gat_net_scan_free(res_p)

        # _parse_fill_walk over the DFS node stream (depth2* state reset
        # per net, exactly the recursive walk's scope)
        chain_id_count = KentHash()
        fill_gap_lists = KentHash()
        depth2gap: dict[int, tuple] = {}
        depth2chain: dict[int, int] = {}
        cur_net = -1
        for depth, t_start, t_size, cid, net_idx in nodes:
            if net_idx != cur_net:
                cur_net = net_idx
                depth2gap = {}
                depth2chain = {}
            if cid < 0:
                raise ValueError(
                    "fill line without an id tag in net input (cannot "
                    "resolve break structure)")
            if cid:
                depth2chain[depth] = cid
                if depth > 1:
                    key = str(cid)
                    cnt = chain_id_count.lookup(key)
                    if cnt is None:
                        chain_id_count.add(key, 1)
                    else:
                        chain_id_count.update(key, cnt + 1)
                    g_start, g_end, g_parent, g_depth = depth2gap[depth - 1]
                    fg = FillGapInfo(
                        depth=depth, chain_id=cid, chrom=names[net_idx],
                        fill_start=t_start, fill_end=t_start + t_size,
                        gap_start=g_start, gap_end=g_end,
                        parent_chain_id=g_parent, gap_depth=g_depth)
                    lst = fill_gap_lists.lookup(key)
                    if lst is None:
                        fill_gap_lists.add(key, [fg])
                    else:
                        lst.append(fg)
            else:
                depth2gap[depth] = (t_start, t_start + t_size,
                                    depth2chain[depth - 1], depth)

        # _r_convert / _add_ali_blocks over the flat stream: for each fill,
        # cut its span at child gaps that have children (nextGapWithInsert)
        tree = _MergedRanges()
        n = len(nodes)
        for i, (depth, t_start, t_size, cid, net_idx) in enumerate(nodes):
            if not cid:
                continue
            name = names[net_idx]
            cursor = t_start
            j = i + 1
            child_depth = depth + 1
            while j < n and nodes[j][0] > depth:
                nd = nodes[j]
                if nd[0] == child_depth and \
                        (j + 1 < n and nodes[j + 1][0] > child_depth):
                    tree.add(name, cursor, nd[1], cid)
                    cursor = nd[1] + nd[2]
                j += 1
            tree.add(name, cursor, t_start + t_size, cid)
        tree.build()
        self._valid_breaks(chain_id_count, fill_gap_lists, tree)
        return True

    def _valid_breaks(self, chain_id_count: KentHash,
                      fill_gap_lists: KentHash, tree: _MergedRanges) -> None:
        # getValidBreaks per hashTraverseEls(chainId2Count)
        for key, count in chain_id_count.traverse_order():
            if count == 1:
                continue
            fg_list: list[FillGapInfo] = fill_gap_lists.lookup(key)
            for a, b in zip(fg_list, fg_list[1:]):
                # -onlyThisChr/-onlyThisStart/-onlyThisEnd restrict to one
                # suspect region (chainCleaner.c:999-1003); Start matches
                # the left gap end, End the right gap start
                if self.only_this_chr is not None:
                    if a.chrom != self.only_this_chr:
                        continue
                    if self.only_this_start != a.gap_end:
                        continue
                    if self.only_this_end != b.gap_start:
                        continue
                if a.depth != b.depth:
                    continue
                if a.parent_chain_id != b.parent_chain_id:
                    continue
                if self._broken_by_higher(tree, a.chrom, a.fill_end,
                                          b.fill_start, a.chain_id,
                                          a.parent_chain_id):
                    continue
                if a.gap_start == b.gap_start and a.gap_end == b.gap_end:
                    continue
                brk = BreakInfo(a.depth, a.chain_id, a.parent_chain_id,
                                a.chrom, a.fill_start, a.fill_end,
                                b.fill_start, b.fill_end,
                                a.gap_start, a.gap_end,
                                b.gap_start, b.gap_end)
                self._hash_add_true(self.chain_of_interest, a.chain_id)
                self._hash_add_true(self.chain_of_interest, a.parent_chain_id)
                pkey = str(a.parent_chain_id)
                lst = self.break_hash.lookup(pkey)
                if lst is None:
                    self.break_hash.add(pkey, [brk])
                else:
                    lst.append(brk)

    @staticmethod
    def _hash_add_true(h: KentHash, chain_id: int):
        key = str(chain_id)
        if key not in h:
            h.add(key, True)

    @staticmethod
    def _broken_by_higher(tree: _MergedRanges, chrom, start, end, chain_id,
                          parent_chain_id) -> bool:
        for cid in tree.overlapping_ids(chrom, start, end):
            if cid < chain_id and cid != parent_chain_id:
                return True
        return False

    # ------------------------------------------------------------------
    def read_chains(self, chain_file: str, passthrough_out) -> None:
        """readChainsOfInterest: keep breaking/broken chains, write rest.

        Input '#' meta lines are echoed to the output at encounter
        (lineFileSetMetaDataOutput on finalChainOutFile,
        chainCleaner.c:590)."""
        meta = lambda line: passthrough_out.write(line + "\n")
        interest_f = self.debug_out.get("interest")
        for chain in iter_chains(chain_file, meta_out=meta):
            if self.max_chain_id < chain.id:
                self.max_chain_id = chain.id
            if self.only_this_chr is not None \
                    and chain.t_name != self.only_this_chr:
                continue  # dropped entirely (chainCleaner.c:600-601)
            if str(chain.id) in self.chain_of_interest:
                self.chains[chain.id] = chain
                if interest_f is not None:
                    interest_f.write(chain.to_text())
            else:
                passthrough_out.write(chain.to_text())

    def split_chains(self, chains: list[Chain]) -> list[Chain]:
        """readChainsOfInterest over a pre-parsed list: store breaking and
        broken chains, return the pass-through rest (in input order)."""
        passthrough: list[Chain] = []
        interest_f = self.debug_out.get("interest")
        for chain in chains:
            if self.max_chain_id < chain.id:
                self.max_chain_id = chain.id
            if self.only_this_chr is not None \
                    and chain.t_name != self.only_this_chr:
                continue  # dropped entirely (chainCleaner.c:600-601)
            if str(chain.id) in self.chain_of_interest:
                self.chains[chain.id] = chain
                if interest_f is not None:
                    interest_f.write(chain.to_text())
            else:
                passthrough.append(chain)
        return passthrough

    def split_table(self, table) -> "np.ndarray":
        """readChainsOfInterest over a ChainTable: materialize python
        Chain objects only for breaking/broken chains; return passthrough
        row indices (their text is re-serialized straight from the SoA
        columns, no objects)."""
        ids = table.ids
        if ids.shape[0]:
            self.max_chain_id = max(self.max_chain_id, int(ids.max()))
        sel = np.arange(len(table))
        if self.only_this_chr is not None:
            (t_fac_ids, t_fac_names), _ = table.names_factorized()
            keep = np.array([nm == self.only_this_chr
                             for nm in t_fac_names], bool)
            sel = sel[keep[t_fac_ids[sel]]]
        interest_ids = np.array(
            [int(k) for k, _ in self.chain_of_interest.traverse_order()],
            np.int64)
        mask = np.isin(ids[sel], interest_ids)
        interest_idx = sel[mask]
        pass_idx = sel[~mask]
        interest_f = self.debug_out.get("interest")
        for i in interest_idx.tolist():
            c = table.materialize(i)
            self.chains[c.id] = c
            if interest_f is not None:
                interest_f.write(c.to_text())
        return pass_idx

    # ------------------------------------------------------------------
    def _get_chain_score(self, chain: Chain) -> tuple[float, float]:
        """getChainScore: sets chain.score to global; returns (global, local)."""
        bs, gc = self.scorer.score_arrays(chain)
        g = float(chain_global_score(bs, gc))
        loc = float(chain_local_score(bs, gc))
        chain.score = g
        return g, loc

    def _score_sub(self, chain: Chain, start: int, end: int) -> tuple:
        """(global, local, ali_bases, exists) of chain.subset_on_t(start,end).

        Served from the batched prescore cache when no later block removal
        on `chain` overlaps [start,end); recomputed on the host scorer
        otherwise (bit-identical)."""
        key = (chain.id, start, end)
        hit = self._sub_cache.get(key)
        if hit is not None and self._entry_valid(chain.id, start, end, hit[4]):
            res = hit[:4]
        else:
            self._cache_misses += 1
            sub = chain.subset_on_t(start, end)
            if sub is None:
                res = (0.0, 0.0, 0, False)
            else:
                bs, gc = self.host_scorer.score_arrays(sub)
                res = (float(chain_global_score(bs, gc)),
                       float(chain_local_score(bs, gc)),
                       int((sub.blocks[:, 1] - sub.blocks[:, 0]).sum()), True)
            self._sub_cache[key] = res + (self._seq,)
        if res[3] and start <= chain.t_start and end >= chain.t_end:
            # chainSubsetOnT returns the ORIGINAL chain on full cover
            # (chain.c:471-488), so C's getChainScore mutates the stored
            # chain's score - later tests and the final write see it
            chain.score = res[0]
        return res

    def _entry_valid(self, chain_id: int, start: int, end: int,
                     entry_seq: int) -> bool:
        for (s, e, sq) in self._removed_ranges.get(chain_id, ()):
            if sq > entry_seq and s < end and e > start:
                return False
        return True

    def _mark_removed(self, chain_id: int, start: int, end: int) -> None:
        self._seq += 1
        self._removed_ranges.setdefault(chain_id, []).append(
            (start, end, self._seq))

    def _prescore_breaks(self, allowed_parents=None) -> None:
        """Score every pending break's 4 sub-chains in one batch (the
        reference scores them one at a time inside testAndRemoveSuspect,
        chainCleaner.c:1214-1229).

        Host path: gat_subset_scores fuses chainSubsetOnT + per-base LUT
        sums + gapCalc + the global/local scan into one threaded native
        pass straight from the genome code arrays - no python subset
        objects.  Device scorers cut every job from the row chains' arrays
        at once and score them in one score_subsets call; scorers with only
        score_chains get materialized subsets through one batch."""
        if self._prescore_native(allowed_parents):
            return
        scorer = self.scorer
        if hasattr(scorer, "score_subsets") and not getattr(
                getattr(scorer, "_dev", None), "host_native", False):
            from ..ops.rescore import ChainRows
            chains, keys, jobs, chain_off, blocks = \
                self._prescore_jobs(allowed_parents)
            if not keys:
                return
            out = scorer.score_subsets(ChainRows(chains),
                                       np.arange(len(chains)), blocks,
                                       chain_off, jobs)
            PERF["cleaner_prescore_table"] += len(keys)
            for key, row in zip(keys, out.tolist()):
                self._sub_cache[key] = (float(row[0]), float(row[1]),
                                        int(row[2]), bool(row[3]), self._seq)
            return
        if not hasattr(scorer, "score_chains"):
            return
        chains, keys, jobs, _, _ = self._prescore_jobs(allowed_parents)
        subs: list[Chain] = []
        sub_keys: list[tuple[int, int, int]] = []
        for key, (row, start, end) in zip(keys, jobs.tolist()):
            sub = chains[row].subset_on_t(start, end)
            if sub is None:
                self._sub_cache[key] = (0.0, 0.0, 0, False, self._seq)
            else:
                subs.append(sub)
                sub_keys.append(key)
        PERF["cleaner_prescore_python"] += len(keys)
        if not subs:
            return
        scored = scorer.score_chains(subs)
        for key, (g, loc, ali) in zip(sub_keys, scored):
            self._sub_cache[key] = (float(g), float(loc), int(ali), True,
                                    self._seq)

    def _prescore_jobs(self, allowed_parents):
        """The prescore's jobs: each pending break's four sub-chains in the
        order testAndRemoveSuspect asks for them, each (chain.id, start,
        end) once.  Returns (chains, keys, jobs, chain_off, blocks): row k is
        chains[k], its blocks blocks[chain_off[k]:chain_off[k + 1]] (int64);
        jobs[i] is the (row, start, end) of cache key keys[i]."""
        rows: dict[int, int] = {}
        chains: list[Chain] = []
        jobs: list[tuple[int, int, int]] = []
        keys: list[tuple[int, int, int]] = []
        seen: set[tuple[int, int, int]] = set()

        def enqueue(chain: Chain | None, start: int, end: int):
            if chain is None:
                return
            key = (chain.id, start, end)
            if key in seen:
                return
            seen.add(key)
            row = rows.get(chain.id)
            if row is None:
                row = rows[chain.id] = len(chains)
                chains.append(chain)
            jobs.append((row, start, end))
            keys.append(key)

        for key, break_list in self.break_hash.el_list_order():
            if allowed_parents is not None and key not in allowed_parents:
                continue
            for brk in break_list:
                enqueue(self.chains.get(brk.parent_chain_id),
                        brk.suspect_start, brk.suspect_end)
                broken = self.chains.get(brk.chain_id)
                enqueue(broken, brk.l_fill_start, brk.r_fill_end)
                enqueue(broken, brk.l_fill_start, brk.suspect_end)
                enqueue(broken, brk.suspect_start, brk.r_fill_end)
        chain_off = np.zeros(len(chains) + 1, np.int64)
        np.cumsum([c.n_blocks for c in chains], out=chain_off[1:])
        blocks = (np.concatenate([c.blocks for c in chains]).astype(
            np.int64, copy=False) if chains else np.zeros((0, 4), np.int64))
        return (chains, keys, np.array(jobs, np.int64).reshape(-1, 3),
                chain_off, blocks)

    def _prescore_native(self, allowed_parents) -> bool:
        """gat_subset_scores fast path; False -> caller uses the batched
        python/device path (device scorers want the device batch)."""
        scorer = self.scorer
        dev = getattr(scorer, "_dev", None)
        host_backed = (dev is None and hasattr(scorer, "t_genome")) or \
            (dev is not None and getattr(dev, "host_native", False))
        if not host_backed or not hasattr(scorer, "t_genome"):
            return False
        from ..native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "gat_subset_scores"):
            return False
        import ctypes

        chain_list, keys, jobs_arr, chain_off, blocks = \
            self._prescore_jobs(allowed_parents)
        if not keys:
            return True
        n_rows = len(chain_list)
        code_refs = []  # keep the code arrays alive across the call
        t_ptrs = (ctypes.c_void_p * n_rows)()
        q_ptrs = (ctypes.c_void_p * n_rows)()
        for i, c in enumerate(chain_list):
            tc = np.ascontiguousarray(
                scorer.t_genome.codes(c.t_name, "+"))
            qc = np.ascontiguousarray(
                scorer.q_genome.codes(c.q_name, c.q_strand))
            code_refs.append((tc, qc))
            t_ptrs[i] = tc.ctypes.data
            q_ptrs[i] = qc.ctypes.data
        lut25 = np.zeros(25, np.int32)
        lut = np.asarray(scorer.scheme.lut)
        for qv in range(min(5, lut.shape[0])):
            for tv in range(min(5, lut.shape[1])):
                lut25[qv * 5 + tv] = lut[qv, tv]
        out = np.empty((len(keys), 4), np.int64)
        gc = scorer.gap_calc
        import os as _os
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gat_subset_scores(
            blocks.ctypes.data_as(i64p), chain_off.ctypes.data_as(i64p),
            n_rows, t_ptrs, q_ptrs,
            lut25.ctypes.data_as(i32p),
            jobs_arr.ctypes.data_as(i64p), len(keys),
            int(gc.small_size),
            gc.q_small.ctypes.data_as(i64p),
            gc.t_small.ctypes.data_as(i64p),
            gc.b_small.ctypes.data_as(i64p),
            gc.long_pos.ctypes.data_as(i64p), int(gc.long_pos.shape[0]),
            np.ascontiguousarray(gc.q_long).ctypes.data_as(f64p),
            np.ascontiguousarray(gc.t_long).ctypes.data_as(f64p),
            np.ascontiguousarray(gc.b_long).ctypes.data_as(f64p),
            out.ctypes.data_as(i64p),
            min(_os.cpu_count() or 1, 16))
        del code_refs
        for key, row in zip(keys, out):
            self._sub_cache[key] = (float(row[0]), float(row[1]),
                                    int(row[2]), bool(row[3]), self._seq)
        return True

    def _test_and_remove(self, brk: BreakInfo, upstream: BreakInfo | None,
                         downstream: BreakInfo | None,
                         is_pair: bool) -> tuple[bool, bool]:
        """testAndRemoveSuspect.  Returns (removed, breaks_updated)."""
        breaking = self.chains.get(brk.parent_chain_id)
        if breaking is None:
            raise KeyError(f"breaking chain {brk.parent_chain_id} missing")
        broken = self.chains.get(brk.chain_id)
        if broken is None:
            raise KeyError(f"broken chain {brk.chain_id} missing")
        breaking_score = breaking.score
        broken_score = broken.score

        sus_global, suspect_local, suspect_bases, sus_exists = \
            self._score_sub(breaking, brk.suspect_start, brk.suspect_end)
        if not sus_exists:
            # suspect already deleted by an earlier removal this iteration
            # (chainCleaner.c:1221-1224)
            return False, False
        fill_global, fill_local = self._score_sub(
            broken, brk.l_fill_start, brk.r_fill_end)[:2]
        lfill_global, lfill_local = self._score_sub(
            broken, brk.l_fill_start, brk.suspect_end)[:2]
        rfill_global, rfill_local = self._score_sub(
            broken, brk.suspect_start, brk.r_fill_end)[:2]

        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = float(np.float64(fill_global) / np.float64(suspect_local))
            ratio_l = float(np.float64(lfill_global) / np.float64(suspect_local))
            ratio_r = float(np.float64(rfill_global) / np.float64(suspect_local))

        lr_threshold = self.lr_fold_pairs if is_pair else self.lr_fold
        removed = (
            ratio_l >= lr_threshold and ratio_r >= lr_threshold
            and ratio >= self.fold
            and suspect_local <= self.max_suspect_score
            and suspect_bases <= self.max_suspect_bases
            and broken_score >= self.min_broken_score
            and (brk.l_gap_end - brk.l_gap_start) >= self.min_lr_gap
            and (brk.r_gap_end - brk.r_gap_start) >= self.min_lr_gap
        )

        if self.suspect_data_out is not None:
            # -suspectDataFile: dump this break's data, never remove
            # (chainCleaner.c:1282-1310)
            removed = False
            self._suspect_id += 1
            self.suspect_data_out.write(
                "%s\t%d\t%d\t%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d\n"
                % (brk.chrom, brk.suspect_start, brk.suspect_end,
                   self._suspect_id, brk.parent_chain_id,
                   int(breaking_score), brk.chain_id, int(broken_score),
                   int(suspect_local), int(fill_global),
                   int(lfill_global), int(rfill_global),
                   suspect_bases,
                   brk.l_gap_end - brk.l_gap_start,
                   brk.r_gap_end - brk.r_gap_start,
                   int(lfill_local), int(rfill_local)))

        if self.debug_out:
            # -debug: write the 4 sub-chains and the suspect/fill bed
            # entries (chainCleaner.c:1312-1321); the sub-chains carry the
            # parent chain's id and the getChainScore global score
            def _sub_with_score(chain, start, end, global_score):
                sub = chain.subset_on_t(start, end)
                sub.score = global_score
                return sub

            di = self._debug_info
            self.debug_out["suspect"].write(_sub_with_score(
                breaking, brk.suspect_start, brk.suspect_end,
                sus_global).to_text())
            self.debug_out["lfill"].write(_sub_with_score(
                broken, brk.l_fill_start, brk.suspect_end,
                lfill_global).to_text())
            self.debug_out["rfill"].write(_sub_with_score(
                broken, brk.suspect_start, brk.r_fill_end,
                rfill_global).to_text())
            self.debug_out["fill"].write(_sub_with_score(
                broken, brk.l_fill_start, brk.r_fill_end,
                fill_global).to_text())
            bed = self.debug_out["bed"]
            bed.write("%s\t%d\t%d\t%s%sSuspect__score_%.0f__Rleft_%.2f"
                      "__Rright_%.2f\t1000\t+\t%d\t%d\t255,0,0\n"
                      % (brk.chrom, brk.suspect_start, brk.suspect_end,
                         "REMOVED_" if removed else "", di, suspect_local,
                         ratio_l, ratio_r,
                         brk.suspect_start, brk.suspect_end))
            bed.write("%s\t%d\t%d\t%sFill__score_%.0f\t1000\t+\t%d\t%d\t"
                      "0,0,255\n" % (brk.chrom, brk.l_fill_start,
                                     brk.r_fill_end, di, fill_global,
                                     brk.l_fill_start, brk.r_fill_end))
            bed.write("%s\t%d\t%d\t%sLfill__score_%.0f\t1000\t+\t%d\t%d\t"
                      "0,125,255\n" % (brk.chrom, brk.l_fill_start,
                                       brk.suspect_end, di, lfill_global,
                                       brk.l_fill_start, brk.l_fill_end))
            bed.write("%s\t%d\t%d\t%sRfill__score_%.0f\t1000\t+\t%d\t%d\t"
                      "0,125,255\n" % (brk.chrom, brk.suspect_start,
                                       brk.r_fill_end, di, rfill_global,
                                       brk.r_fill_start, brk.r_fill_end))

        breaks_updated = False
        if removed:
            self._hash_add_true(self.needs_rescoring, breaking.id)
            color = "0,100,255" if is_pair else "0,0,153"
            self.bed_lines.append(
                f"{brk.chrom}\t{brk.suspect_start}\t{brk.suspect_end}\t"
                f"breakingChainID_{brk.parent_chain_id}_Score_{int(breaking_score)}"
                f"_brokenChainID_{brk.chain_id}_Score_{int(broken_score)}"
                f"_suspectLocalScore_{int(suspect_local)}"
                f"_RatioL_{ratio_l:.2f}_RatioR_{ratio_r:.2f}\t1000\t+\t"
                f"{brk.suspect_start}\t{brk.suspect_end}\t{color}\n")
            sub_suspect = breaking.subset_on_t(brk.suspect_start,
                                               brk.suspect_end)
            sub_suspect.score = sus_global  # getChainScore side effect
            breaking.remove_blocks_in_t_range(brk.suspect_start, brk.suspect_end)
            self._mark_removed(breaking.id, brk.suspect_start, brk.suspect_end)
            self.max_chain_id += 1
            sub_suspect.id = self.max_chain_id
            self.new_id_dict.append((sub_suspect.id, breaking.id))
            self.suspect_chains.append(sub_suspect)
            self.removal_tags.append((self._cur_list_pos,
                                      self._list_removal_seq))
            self._list_removal_seq += 1

            if upstream is not None:
                if (brk.chain_id == upstream.chain_id
                        and brk.parent_chain_id == upstream.parent_chain_id
                        and upstream.r_fill_start == brk.l_fill_start
                        and upstream.r_fill_end == brk.l_fill_end):
                    breaks_updated = True
                    assert upstream.l_fill_end < brk.l_fill_start
                    assert upstream.suspect_end < brk.suspect_start
                    upstream.r_fill_end = brk.r_fill_end
                    upstream.r_gap_end = brk.r_gap_end
            if downstream is not None:
                if (brk.chain_id == downstream.chain_id
                        and brk.parent_chain_id == downstream.parent_chain_id
                        and downstream.l_fill_start == brk.r_fill_start
                        and downstream.l_fill_end == brk.r_fill_end):
                    breaks_updated = True
                    assert downstream.r_fill_start > brk.r_fill_end
                    assert downstream.suspect_start > brk.suspect_end
                    downstream.l_fill_start = brk.l_fill_start
                    downstream.l_gap_start = brk.l_gap_start
        return removed, breaks_updated

    def components(self) -> list[list[str]]:
        """Connected components of break lists (parent keys), ordered by
        first appearance in el_list_order.

        Two break lists are coupled iff they share a chain (a chain that
        is breaking in one list and broken in another: removals mutate the
        breaking chain and scoring reads broken chains, so only
        same-component lists can observe each other's effects).  Lists in
        different components are order-independent - the multi-host shard
        unit (SURVEY §5.8)."""
        parent = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        lists = list(self.break_hash.el_list_order())
        for key, break_list in lists:
            pid = int(key)
            for brk in break_list:
                union(pid, brk.chain_id)
        comps: dict[int, tuple[list[str], set[int]]] = {}
        order: list[int] = []
        for key, break_list in lists:
            root = find(int(key))
            if root not in comps:
                comps[root] = ([], set())
                order.append(root)
            comps[root][0].append(key)
            comps[root][1].add(int(key))
            for brk in break_list:
                comps[root][1].add(brk.chain_id)
        return [comps[r] for r in order]

    def loop_over_breaks(self, allowed_parents: set[str] | None = None) -> None:
        """loopOverBreaks (chainCleaner.c:1452-1631).

        allowed_parents: process only these break lists (sharded mode);
        removal order tags (list position in el_list_order, sequence
        within the list) are recorded so a shard merge reproduces the
        single-run removal order exactly.

        Fast path: the whole fixed-point loop runs in native C++
        (native/breakloop.cpp), parallel over independent components,
        with removals replayed here in sequential order - bit-identical
        to the python loop below, which remains the oracle (and the
        debug / -suspectDataFile / sharded / no-toolchain path)."""
        self.removal_tags: list[tuple[int, int]] = []
        if (allowed_parents is None and not self.debug_out
                and self.suspect_data_out is None
                and os.environ.get("GAT_BREAK_LOOP", "1") != "0"
                and self._loop_over_breaks_native()):
            return
        with phase("cleaner: prescore"):
            self._prescore_breaks(allowed_parents)
        for self._cur_list_pos, (key, break_list) in enumerate(
                self.break_hash.el_list_order()):
            if allowed_parents is not None and key not in allowed_parents:
                continue
            self._list_removal_seq = 0
            total_num_iteration = 0  # per breaking chain (chainCleaner.c:1477)
            while True:  # overall iteration (singles then pairs)
                # --- singles fixed point ---
                while True:
                    total_num_iteration += 1
                    self._debug_info = "SINGLE_%d" % total_num_iteration
                    any_updated_single = False
                    i = 0
                    while i < len(break_list):
                        brk = break_list[i]
                        upstream = break_list[i - 1] if i > 0 else None
                        downstream = break_list[i + 1] if i + 1 < len(break_list) else None
                        removed, updated = self._test_and_remove(
                            brk, upstream, downstream, is_pair=False)
                        if updated:
                            any_updated_single = True
                        if removed:
                            del break_list[i]
                        else:
                            i += 1
                    if not any_updated_single or not break_list:
                        break

                any_updated_pair = False
                if self.do_pairs:
                    total_num_iteration += 1
                    self._debug_info = "PAIR_%d" % total_num_iteration
                    i = 0
                    while i < len(break_list) - 1:
                        up = break_list[i]
                        down = break_list[i + 1]
                        if self._is_valid_pair(up, down):
                            pair = BreakInfo(
                                up.depth, up.chain_id, up.parent_chain_id,
                                up.chrom, up.l_fill_start, up.l_fill_end,
                                down.r_fill_start, down.r_fill_end,
                                up.l_gap_start, up.l_gap_end,
                                down.r_gap_start, down.r_gap_end)
                            before = break_list[i - 1] if i > 0 else None
                            after = (break_list[i + 2]
                                     if i + 2 < len(break_list) else None)
                            removed, updated = self._test_and_remove(
                                pair, before, after, is_pair=True)
                            if updated:
                                any_updated_pair = True
                            if removed:
                                del break_list[i:i + 2]
                            else:
                                i += 1
                        else:
                            i += 1

                if not any_updated_pair or not break_list:
                    break

    def _loop_over_breaks_native(self) -> bool:
        """Run the whole break loop in native C++ (breakloop.cpp); returns
        False when unavailable (no lib, device-batched scorer, missing
        chain) so the caller falls through to the python loop."""
        scorer = self.scorer
        dev = getattr(scorer, "_dev", None)
        host_backed = (dev is None and hasattr(scorer, "t_genome")) or \
            (dev is not None and getattr(dev, "host_native", False))
        if not host_backed or not hasattr(scorer, "t_genome"):
            return False
        from ..native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "gat_break_loop"):
            return False
        import ctypes

        from ..ops.pair_rescore import _n_threads

        lists = list(self.break_hash.el_list_order())
        if not lists:
            return True
        rows: dict[int, int] = {}
        chain_list: list[Chain] = []

        def row_of(cid: int) -> int | None:
            row = rows.get(cid)
            if row is None:
                c = self.chains.get(cid)
                if c is None:
                    return None
                row = rows[cid] = len(chain_list)
                chain_list.append(c)
            return row

        chroms: list[str] = []
        chrom_idx: dict[str, int] = {}
        breaks_rows: list[list[int]] = []
        list_off = [0]
        for _key, break_list in lists:
            for brk in break_list:
                pr = row_of(brk.parent_chain_id)
                br = row_of(brk.chain_id)
                if pr is None or br is None:
                    return False  # python loop raises the exact KeyError
                ci = chrom_idx.get(brk.chrom)
                if ci is None:
                    ci = chrom_idx[brk.chrom] = len(chroms)
                    chroms.append(brk.chrom)
                breaks_rows.append([
                    brk.depth, br, pr, ci,
                    brk.l_fill_start, brk.l_fill_end,
                    brk.r_fill_start, brk.r_fill_end,
                    brk.l_gap_start, brk.l_gap_end,
                    brk.r_gap_start, brk.r_gap_end])
            list_off.append(len(breaks_rows))
        n_rows = len(chain_list)
        n_blocks = np.empty(n_rows, np.int64)
        blk_ptrs = (ctypes.c_void_p * n_rows)()
        blk_refs = []  # keep non-contiguous copies alive across the call
        scores = np.empty(n_rows, np.float64)
        t_bounds = np.empty((n_rows, 2), np.int64)
        t_ptrs = (ctypes.c_void_p * n_rows)()
        q_ptrs = (ctypes.c_void_p * n_rows)()
        code_refs = []
        code_cache: dict[tuple, tuple] = {}
        for i, c in enumerate(chain_list):
            b = c.blocks
            if not b.flags.c_contiguous or b.dtype != np.int64:
                b = np.ascontiguousarray(b, np.int64)
                blk_refs.append(b)
            blk_ptrs[i] = b.ctypes.data
            n_blocks[i] = b.shape[0]
            scores[i] = c.score
            t_bounds[i, 0] = c.t_start
            t_bounds[i, 1] = c.t_end
            ck = (c.t_name, c.q_name, c.q_strand)
            ptrs = code_cache.get(ck)
            if ptrs is None:
                tc = np.ascontiguousarray(
                    scorer.t_genome.codes(c.t_name, "+"))
                qc = np.ascontiguousarray(
                    scorer.q_genome.codes(c.q_name, c.q_strand))
                code_refs.append((tc, qc))
                ptrs = code_cache[ck] = (tc.ctypes.data, qc.ctypes.data)
            t_ptrs[i] = ptrs[0]
            q_ptrs[i] = ptrs[1]
        lut25 = np.zeros(25, np.int32)
        lut = np.asarray(self.host_scorer.scheme.lut)
        for qv in range(min(5, lut.shape[0])):
            for tv in range(min(5, lut.shape[1])):
                lut25[qv * 5 + tv] = lut[qv, tv]
        gc = self.host_scorer.gap_calc
        breaks_arr = np.asarray(breaks_rows, np.int64)
        list_off_arr = np.asarray(list_off, np.int64)
        max_bases = int(min(float(self.max_suspect_bases), float(2 ** 62)))
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        res_p = lib.gat_break_loop(
            n_rows, blk_ptrs, n_blocks.ctypes.data_as(i64p),
            scores.ctypes.data_as(f64p), t_bounds.ctypes.data_as(i64p),
            t_ptrs, q_ptrs, lut25.ctypes.data_as(i32p),
            int(gc.small_size),
            gc.q_small.ctypes.data_as(i64p),
            gc.t_small.ctypes.data_as(i64p),
            gc.b_small.ctypes.data_as(i64p),
            gc.long_pos.ctypes.data_as(i64p), int(gc.long_pos.shape[0]),
            np.ascontiguousarray(gc.q_long).ctypes.data_as(f64p),
            np.ascontiguousarray(gc.t_long).ctypes.data_as(f64p),
            np.ascontiguousarray(gc.b_long).ctypes.data_as(f64p),
            len(lists), list_off_arr.ctypes.data_as(i64p),
            breaks_arr.shape[0], breaks_arr.ctypes.data_as(i64p),
            float(self.fold), float(self.lr_fold),
            float(self.lr_fold_pairs),
            float(self.max_suspect_score), max_bases,
            float(self.min_broken_score), int(self.min_lr_gap),
            1 if self.do_pairs else 0, int(self.max_pair_distance),
            _n_threads())
        try:
            res = res_p.contents
            err = bytes(res.error).split(b"\0")[0]
            if err:
                # fall back to the python loop (raises the exact error)
                return False
            n = int(res.n_removals)
            if n == 0:
                # Even with nothing removed, the native loop may have
                # applied getChainScore's full-cover side effect (the C
                # reference mutates chain->score via chainSubsetOnT's
                # original-chain return, chain.c:471-488) - propagate it
                # so written scores stay byte-identical.
                final_scores = np.ctypeslib.as_array(
                    res.final_scores, shape=(n_rows,)).copy()
                score_set = np.ctypeslib.as_array(
                    res.score_set, shape=(n_rows,)).copy()
                for i in np.flatnonzero(score_set):
                    chain_list[int(i)].score = float(final_scores[int(i)])
                del code_refs
                return True
            rem_i = np.ctypeslib.as_array(res.rem_i, shape=(n, 8)).copy()
            rem_d = np.ctypeslib.as_array(res.rem_d, shape=(n, 6)).copy()
            sus_off = np.ctypeslib.as_array(res.sus_off,
                                            shape=(n + 1,)).copy()
            sus_blocks = np.ctypeslib.as_array(
                res.sus_blocks, shape=(int(sus_off[-1]), 4)).copy()
            final_scores = np.ctypeslib.as_array(res.final_scores,
                                                 shape=(n_rows,)).copy()
            score_set = np.ctypeslib.as_array(res.score_set,
                                              shape=(n_rows,)).copy()
            rescored = np.ctypeslib.as_array(res.rescored,
                                             shape=(n_rows,)).copy()
            rescored_set = np.ctypeslib.as_array(res.rescored_set,
                                                 shape=(n_rows,)).copy()
        finally:
            lib.gat_break_loop_free(res_p)
        del code_refs
        # replay removals in sequential order (sorted by native already);
        # block removal is batched per chain at the end - removals on a
        # chain are disjoint t-ranges and the native loop already enforced
        # the stepwise first/last-block-survives checks, so the final
        # block set equals the sequential removes
        pending_rm: dict[int, list[tuple[int, int]]] = {}
        for i in range(n):
            (list_pos, seq, ci, sus_s, sus_e, pr, br,
             is_pair) = (int(v) for v in rem_i[i])
            (breaking_score, broken_score, suspect_local, ratio_l,
             ratio_r, sus_global) = (float(v) for v in rem_d[i])
            breaking = chain_list[pr]
            broken_id = chain_list[br].id
            # no needs_rescoring entry: the native loop already rescored
            # every mutated chain's final blocks (rescored/rescored_set)
            color = "0,100,255" if is_pair else "0,0,153"
            self.bed_lines.append(
                f"{chroms[ci]}\t{sus_s}\t{sus_e}\t"
                f"breakingChainID_{breaking.id}_Score_{int(breaking_score)}"
                f"_brokenChainID_{broken_id}_Score_{int(broken_score)}"
                f"_suspectLocalScore_{int(suspect_local)}"
                f"_RatioL_{ratio_l:.2f}_RatioR_{ratio_r:.2f}\t1000\t+\t"
                f"{sus_s}\t{sus_e}\t{color}\n")
            nb = np.ascontiguousarray(
                sus_blocks[int(sus_off[i]):int(sus_off[i + 1])])
            self.max_chain_id += 1
            sub_suspect = Chain(
                score=sus_global,
                t_name=breaking.t_name, t_size=breaking.t_size,
                t_start=int(nb[0, 0]), t_end=int(nb[-1, 1]),
                q_name=breaking.q_name, q_size=breaking.q_size,
                q_strand=breaking.q_strand,
                q_start=int(nb[:, 2].min()), q_end=int(nb[:, 3].max()),
                id=self.max_chain_id, blocks=nb)
            self.new_id_dict.append((sub_suspect.id, breaking.id))
            self.suspect_chains.append(sub_suspect)
            self.removal_tags.append((list_pos, seq))
            pending_rm.setdefault(pr, []).append((sus_s, sus_e))
            self._mark_removed(breaking.id, sus_s, sus_e)
        for pr, ranges in pending_rm.items():
            chain = chain_list[pr]
            b = chain.blocks
            drop = np.zeros(b.shape[0], bool)
            for (s, e) in ranges:
                lo = int(np.searchsorted(b[:, 0], s, side="left"))
                hi = int(np.searchsorted(b[:, 0], e, side="left"))
                drop[lo:hi] = True
            chain.blocks = b[~drop]
        for i in np.flatnonzero(score_set):
            chain_list[int(i)].score = float(final_scores[int(i)])
        # write-path getChainScore of mutated chains (overrides any
        # full-cover side effect, as the python write-time rescore does)
        for i in np.flatnonzero(rescored_set):
            chain_list[int(i)].score = float(rescored[int(i)])
        return True

    def _is_valid_pair(self, up: BreakInfo, down: BreakInfo) -> bool:
        if (up.parent_chain_id != down.parent_chain_id
                or up.chain_id != down.chain_id):
            return False
        if up.depth != down.depth:
            return False
        if down.suspect_start - up.suspect_end > self.max_pair_distance:
            return False
        return (up.r_gap_start == down.l_gap_start
                and up.r_gap_end == down.l_gap_end)

    # ------------------------------------------------------------------
    def write_chains_of_interest(self, out) -> None:
        """writeAndFreeChainsOfInterest over hashTraverseEls order.

        Rescoring of all modified chains is batched into one device round
        trip (the reference rescored them one by one at write time,
        chainCleaner.c:625-643)."""
        for chain in self.chains_of_interest_for_output():
            out.write(chain.to_text())

    def interest_for_shard(self, owned_ids: set[int]) -> list[tuple[int, str]]:
        """(global_traverse_pos, chain_text) for owned chains of interest,
        with owned modified chains rescored - the shard half of
        writeAndFreeChainsOfInterest."""
        order = list(self.chain_of_interest.traverse_order())
        rescore = [self.chains[int(key)] for key, _ in order
                   if key in self.needs_rescoring and int(key) in owned_ids]
        if rescore and hasattr(self.scorer, "score_chains"):
            for chain, (g, _loc, _ali) in zip(
                    rescore, self.scorer.score_chains(rescore)):
                chain.score = float(g)
        else:
            for chain in rescore:
                self._get_chain_score(chain)
        out = []
        for pos, (key, _) in enumerate(order):
            cid = int(key)
            if cid in owned_ids:
                out.append((pos, self.chains[cid].to_text()))
        return out

    def chains_of_interest_for_output(self) -> list[Chain]:
        """The (rescored) breaking/broken chains in hashTraverseEls order."""
        order = list(self.chain_of_interest.traverse_order())
        rescore = [self.chains[int(key)] for key, _ in order
                   if key in self.needs_rescoring]
        if rescore and hasattr(self.scorer, "score_chains"):
            for chain, (g, _loc, _ali) in zip(
                    rescore, self.scorer.score_chains(rescore)):
                chain.score = float(g)
        else:
            for chain in rescore:
                self._get_chain_score(chain)
        out_chains = []
        for key, _ in order:
            chain = self.chains.get(int(key))
            if chain is None:
                raise KeyError(f"chain {key} missing from chainId2chain")
            out_chains.append(chain)
        return out_chains


def clean_chains(in_chain: str, t_2bit: str, q_2bit: str,
                 out_chain_path: str, out_bed_path: str,
                 net_file: str | None = None,
                 t_sizes: str | None = None, q_sizes: str | None = None,
                 linear_gap: str = "loose", score_scheme: str | None = None,
                 new_chain_id_dict_path: str | None = None,
                 scorer_factory=None, num_shards: int = 1, shard: int = 0,
                 shard_out: str | None = None,
                 debug: bool = False,
                 suspect_data_file: str | None = None,
                 only_this_chr: str | None = None,
                 only_this_start: int = -1,
                 only_this_end: int = -1,
                 device=None,
                 **thresholds) -> None:
    """Full chainCleaner pipeline (chainCleaner.c main, 1678-1899).

    Console transcript mirrors the reference's numbered step banners
    (chainCleaner.c:1730-1886) at verbosity >= 1.

    num_shards/shard: multi-host fan-out over break-list components
    (connected groups of breaking/broken chains, the only coupling unit -
    see ChainCleaner.components).  A shard run writes a bundle to
    shard_out; merge_cleaner_shards() combines bundles into the canonical
    out.chain/out.bed, byte-identical to a single run for any shard count.

    device: where the scorer runs when no scorer_factory is given (cuda
    unless named, which raises without CUDA; ops/rescore.py).
    """
    # cyclic GC off for the run: the pipeline allocates millions of small
    # tuples and jax's gc callback makes every collection pass expensive;
    # refcounting handles all actual frees here
    import gc
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        _clean_chains_impl(
            in_chain, t_2bit, q_2bit, out_chain_path, out_bed_path,
            net_file=net_file, t_sizes=t_sizes, q_sizes=q_sizes,
            linear_gap=linear_gap, score_scheme=score_scheme,
            new_chain_id_dict_path=new_chain_id_dict_path,
            scorer_factory=scorer_factory, num_shards=num_shards,
            shard=shard, shard_out=shard_out, debug=debug,
            suspect_data_file=suspect_data_file,
            only_this_chr=only_this_chr, only_this_start=only_this_start,
            only_this_end=only_this_end, device=device, **thresholds)
    finally:
        if gc_was_enabled:
            gc.enable()


def _clean_chains_impl(in_chain: str, t_2bit: str, q_2bit: str,
                 out_chain_path: str, out_bed_path: str,
                 net_file: str | None = None,
                 t_sizes: str | None = None, q_sizes: str | None = None,
                 linear_gap: str = "loose", score_scheme: str | None = None,
                 new_chain_id_dict_path: str | None = None,
                 scorer_factory=None, num_shards: int = 1, shard: int = 0,
                 shard_out: str | None = None,
                 debug: bool = False,
                 suspect_data_file: str | None = None,
                 only_this_chr: str | None = None,
                 only_this_start: int = -1,
                 only_this_end: int = -1,
                 device=None,
                 **thresholds) -> None:
    import time as _time

    from ..utils.profiling import phase_add
    from ..utils.verbose import print_mem, verbose, verbosity

    _pt = _t0 = _time.monotonic()
    scheme = (read_score_scheme(score_scheme) if score_scheme
              else score_scheme_default())
    gap_calc = gap_calc_from_file(linear_gap)
    t_genome, q_genome = open_genome(t_2bit), open_genome(q_2bit)
    if scorer_factory is None:
        # the torch scorer on the caller's device (all pending break
        # sub-chains are scored in one device round trip) - the same seam
        # as score_chain.py
        from ..ops.rescore import torch_scorer_factory
        scorer_factory = torch_scorer_factory(device)
    factory = scorer_factory or ChainScorer
    scorer = factory(scheme, gap_calc, t_genome, q_genome)
    host_scorer = (scorer if factory is ChainScorer
                   else ChainScorer(scheme, gap_calc, t_genome, q_genome))

    cleaner = ChainCleaner(scorer, host_scorer=host_scorer,
                           only_this_chr=only_this_chr,
                           only_this_start=only_this_start,
                           only_this_end=only_this_end, **thresholds)
    if only_this_chr is not None:
        verbose(1, "ONLY %s %d %d\n"
                % (only_this_chr, only_this_start, only_this_end))
    verbose(1, "Verbosity level: %d\n" % verbosity())
    verbose(1, "foldThreshold: %f    LRfoldThreshold: %f   "
               "maxSuspectBases: %d  maxSuspectScore: %d  "
               "minBrokenChainScore: %d  minLRGapSize: %d"
            % (cleaner.fold, cleaner.lr_fold,
               min(int(cleaner.max_suspect_bases), INT_MAX),
               int(cleaner.max_suspect_score), int(cleaner.min_broken_score),
               cleaner.min_lr_gap))
    if cleaner.do_pairs:
        verbose(1, " doPairs with LRfoldThreshold: %f   maxPairDistance %d\n"
                % (cleaner.lr_fold_pairs, cleaner.max_pair_distance))
    else:
        verbose(1, "\n")
    if score_scheme:
        verbose(1, "Reading scoring matrix from %s\n" % score_scheme)

    # single input parse, shared by netting and chain splitting ('#' meta
    # lines collected in encounter order; the final sorted write puts them
    # at the top, same as the reference's text pipeline ends up doing).
    # Fast path: the whole file stays in ChainTable SoA columns - python
    # Chain objects exist only for the breaking/broken chains; everything
    # else is netted, sorted and re-serialized straight from the columns.
    from ..formats.chain import read_chains as _read_chain_file
    from ..native.chain_io import (concat_tables, parse_chain_table,
                                   soa_from_chains)
    meta_lines: list[str] = []
    table = None
    all_chains = None
    try:
        if in_chain.endswith(".gz"):
            import gzip as _gz
            with _gz.open(in_chain, "rb") as fh:
                _data = fh.read()
        else:
            with open(in_chain, "rb") as fh:
                _data = fh.read()
        table = parse_chain_table(_data)
    except OSError:
        _data = None
    if table is not None:
        # '#' meta lines are rare; scan only when one can exist
        if _data.startswith(b"#") or b"\n#" in _data:
            for bline in _data.split(b"\n"):
                if bline.startswith(b"#"):
                    meta_lines.append(bline.decode())
    else:
        all_chains = _read_chain_file(in_chain, meta_out=meta_lines.append)
    del _data
    phase_add("setup+parse", _time.monotonic() - _pt)
    _pt = _time.monotonic()

    # overlap genome decode (+ '-'-strand revcomp) with the netting /
    # filtering stages: the scorers only touch sequences once breaks are
    # known.  Benign race: Genome caches per chrom, a concurrent first
    # access at worst decodes twice.
    import threading

    def _prefetch_codes():
        try:
            if table is not None:
                (t_ids, t_names_u), (q_ids, q_names_u) = \
                    table.names_factorized()
                for nm in t_names_u:
                    t_genome.codes(nm, "+")
                minus = table.strands == ord("-")
                for j, nm in enumerate(q_names_u):
                    m = q_ids == j
                    if (m & ~minus).any():
                        q_genome.codes(nm, "+")
                    if (m & minus).any():
                        q_genome.codes(nm, "-")
                return
            seen_t, seen_q = set(), set()
            for c in all_chains:
                if c.t_name not in seen_t:
                    seen_t.add(c.t_name)
                    t_genome.codes(c.t_name, "+")
                qk = (c.q_name, c.q_strand)
                if qk not in seen_q:
                    seen_q.add(qk)
                    q_genome.codes(c.q_name, c.q_strand)
        except Exception:
            pass  # scoring will surface any real error

    threading.Thread(target=_prefetch_codes, daemon=True).start()

    if net_file is None:
        if t_sizes is None or q_sizes is None:
            raise ValueError("need -tSizes/-qSizes when no -net is given")
        # in-process netting: chainNet -minScore=0 | NetFilterNonNested
        # -minScore1 3000 (chainCleaner.c:1660); we net in memory instead of
        # through a temp file + process boundary.
        verbose(1, "0. need to net the input chains %s (no net file given) "
                   "...\n" % in_chain)
        net_source = "in-memory net of %s" % in_chain
        from ..native import get_lib as _get_lib
        breaks_done = False
        if (_get_lib() is not None and table is not None
                and only_this_chr is None
                and os.environ.get("GAT_FUSED_BREAKS", "1") != "0"):
            # fused fast path: sweep nodes -> writer subchainInfo ->
            # NetFilterNonNested(12) -> break core, all in C++ without
            # materializing the net text (netscan.cpp
            # gat_breaks_from_sweep); equivalent to the text pipeline
            # below, which remains both the fallback and the oracle the
            # parity tests compare against
            from .chain_net import net_tree_t_for_table
            with phase("cleaner: net"):
                nt = net_tree_t_for_table(table, t_sizes, q_sizes, min_score=0)
            if nt is not None and cleaner.find_breaks_sweep(nt):
                breaks_done = True
                net_text = None
        if breaks_done:
            pass
        elif _get_lib() is not None:
            # all-bytes path: native net writer -> native two-set filter,
            # no str round trips (byte-identical to the python path)
            t_net_b = io.BytesIO()
            # q-side net goes to /dev/null in the reference
            # (chainCleaner.c:1660) - skip formatting it entirely
            with phase("cleaner: net"):
                chain_net(table if table is not None else all_chains,
                          t_sizes, q_sizes, t_net_b, None, min_score=0)
                net_bytes = t_net_b.getvalue()
                from .net_filter_nonnested import filter_net_bytes
                mv = filter_net_bytes(net_bytes, min_score1=3000)
                if mv is not None:
                    net_text = mv
                else:
                    filtered = io.StringIO()
                    net_filter_non_nested(net_bytes.decode().splitlines(),
                                          filtered, min_score1=3000)
                    net_text = filtered.getvalue().encode()
        else:
            with phase("cleaner: net"):
                t_net = io.StringIO()
                chain_net(table if table is not None else all_chains,
                          t_sizes, q_sizes, t_net, None, min_score=0)
                filtered = io.StringIO()
                net_filter_non_nested(t_net.getvalue().splitlines(), filtered,
                                      min_score1=3000)
                net_text = filtered.getvalue().encode()
        verbose(1, "DONE (nets in %s)\n" % net_source)
        verbose(1, "1. parsing fills/gaps from %s and getting valid breaks "
                   "...\n" % net_source)
        verbose(1, "1.1 read net file %s into memory ...\n" % net_source)
        verbose(1, "DONE\n\n")
    else:
        breaks_done = False
        net_source = net_file
        verbose(1, "1. parsing fills/gaps from %s and getting valid breaks "
                   "...\n" % net_source)
        verbose(1, "1.1 read net file %s into memory ...\n" % net_source)
        if net_file.endswith(".gz"):
            import gzip
            with gzip.open(net_file, "rb") as f:
                net_text = f.read()
        else:
            with open(net_file, "rb") as f:
                net_text = f.read()
        verbose(1, "DONE\n\n")

    verbose(1, "1.2 get fills/gaps from %s ...\n" % net_source)
    verbose(1, "1.3 get aligning regions from %s ...\n" % net_source)
    verbose(1, "1.4 get valid breaks ...\n")
    if not breaks_done and not cleaner.find_breaks_text(net_text):
        cleaner.find_breaks(read_nets(io.StringIO(net_text.decode())))
    verbose(1, "DONE\n")
    verbose(1, "DONE (parsing fills/gaps and getting valid breaks)\n\n")
    phase_add("net+find_breaks", _time.monotonic() - _pt)
    _pt = _time.monotonic()

    verbose(1, "2. reading breaking and broken chains from %s and write "
               "irrelevant chains to %s ...\n" % (in_chain, out_chain_path))
    if debug:
        # fixed CWD file names, as the reference (chainCleaner.c:592,
        # 1818-1822)
        cleaner.debug_out["interest"] = open("chainsOfInterest.chain", "w")
    if table is not None:
        pass_idx = cleaner.split_table(table)
        passthrough = None
    else:
        passthrough = cleaner.split_chains(all_chains)
    if debug:
        cleaner.debug_out.pop("interest").close()
    verbose(1, "DONE\n\n")
    phase_add("split_chains", _time.monotonic() - _pt)
    _pt = _time.monotonic()
    verbose(1, "3. reading target and query DNA sequences for breaking and "
               "broken chains ...\n")
    verbose(1, "DONE\n\n")
    verbose(1, "4. loop over all breaks. Remove suspects if they pass our "
               "filters and write out deleted suspects to %s ...\n"
            % out_bed_path)
    if debug:
        cleaner.debug_out.update(
            suspect=open("suspect.chain", "w"),
            lfill=open("brokenChainLfill.chain", "w"),
            rfill=open("brokenChainRfill.chain", "w"),
            fill=open("brokenChainfill.chain", "w"),
            bed=open("suspectsAndFills.bed", "w"))
    if suspect_data_file is not None:
        cleaner.suspect_data_out = open(suspect_data_file, "w")
        # -suspectDataFile forces doPairs off (chainCleaner.c:1830-1832)
        cleaner.do_pairs = False
    allowed = None
    owned_ids: set[int] | None = None
    input_max_id = cleaner.max_chain_id  # before removals assign new ids
    if num_shards > 1:
        from ..parallel.distributed import shard_indices
        comps = cleaner.components()
        idx = shard_indices(len(comps), num_shards, shard)
        allowed = set()
        owned_ids = set()
        for keys, cids in comps[idx.start:idx.stop]:
            allowed.update(keys)
            owned_ids.update(cids)
    cleaner.loop_over_breaks(allowed)
    phase_add("break_loop", _time.monotonic() - _pt)
    _pt = _time.monotonic()
    if suspect_data_file is not None:
        cleaner.suspect_data_out.close()
        cleaner.suspect_data_out = None
    if debug:
        for f in cleaner.debug_out.values():
            f.close()
        cleaner.debug_out.clear()
    verbose(1, "DONE\n\n")

    if num_shards > 1:
        import json
        bundle = {
            "shard": shard,
            "max_chain_id": input_max_id,
            "removals": [
                [pos, seq, cleaner.bed_lines[i],
                 cleaner.new_id_dict[i][1], cleaner.suspect_chains[i].to_text()]
                for i, (pos, seq) in enumerate(cleaner.removal_tags)],
            "interest": cleaner.interest_for_shard(owned_ids),
        }
        if shard == 0:
            if table is not None:
                bundle["passthrough"] = bytes(
                    table.serialize(pass_idx)).decode()
            else:
                from ..formats.chain import write_chains as _wc
                buf = io.StringIO()
                _wc(passthrough, buf)
                bundle["passthrough"] = buf.getvalue()
            bundle["meta"] = meta_lines
        with open(shard_out or out_chain_path, "w") as f:
            json.dump(bundle, f)
        verbose(1, "shard %d/%d bundle written\n" % (shard, num_shards))
        phase_add("chainCleaner", _time.monotonic() - _t0)
        return
    verbose(1, "5. write the (new) breaking and the broken chains to %s "
               "...\n" % out_chain_path)
    # pre-sort order = pass-through (input order), suspects (removal
    # order), chains of interest (hashTraverseEls order) - exactly the
    # reference's unsorted temp-file order before chainSort
    extra = cleaner.suspect_chains + cleaner.chains_of_interest_for_output()
    verbose(1, "DONE\n\n")

    with open(out_bed_path, "w") as f:
        f.writelines(cleaner.bed_lines)
    if new_chain_id_dict_path:
        with open(new_chain_id_dict_path, "w") as f:
            for new_id, old_id in cleaner.new_id_dict:
                f.write(f"{new_id}\t{old_id}\n")

    # chainSort (score desc, stable)
    verbose(1, "6. chainSort %s ...\n" % out_chain_path)
    if table is not None:
        # serialize straight from the SoA columns in chainSort order:
        # passthrough rows come from the input table (never touched),
        # suspects + rescored interest chains are appended as extra rows
        extra_tab = soa_from_chains(extra)
        ctab = concat_tables([table, extra_tab])
        cand = np.concatenate([
            pass_idx.astype(np.int64),
            len(table) + np.arange(len(extra), dtype=np.int64)])
        cand_scores = np.concatenate([table.scores[pass_idx],
                                      extra_tab.scores])
        # kent chainSort tie order is REVERSE file order (slAddHead +
        # stable slSort): stable-argsort the reversed sequence
        cand = cand[::-1]
        order = cand[np.argsort(-cand_scores[::-1], kind="stable")]
        blob = ctab.serialize(order)
        with open(out_chain_path, "wb") as outf:
            for line in meta_lines:
                outf.write(line.encode() + b"\n")
            outf.write(blob)
    else:
        from ..formats.chain import sort_chains_by_score, write_chains
        with open(out_chain_path, "w") as outf:
            for line in meta_lines:
                outf.write(line + "\n")
            write_chains(sort_chains_by_score(passthrough + extra), outf)
    verbose(1, "DONE\n\n")
    phase_add("sort+write", _time.monotonic() - _pt)
    phase_add("chainCleaner", _time.monotonic() - _t0)
    print_mem()
    verbose(1, "\nALL DONE. New chains are in %s. Deleted suspects in %s\n"
            % (out_chain_path, out_bed_path))


def chain_cleaner_main(argv: list[str], device=None) -> int:
    from ..cli.main import _parse_kent_args
    pos, opts = _parse_kent_args(argv)
    if "mergeShards" in opts:
        if len(pos) != 2:
            print("usage: chainCleaner -mergeShards=s0.json,s1.json,... "
                  "out.chain out.bed [-newChainIDDict=f]", file=sys.stderr)
            return 255
        merge_cleaner_shards(opts["mergeShards"].split(","), pos[0], pos[1],
                             opts.get("newChainIDDict"))
        return 0
    if len(pos) != 5:
        print("usage: chainCleaner in.chain t.2bit q.2bit out.chain out.bed "
              "{-net=in.net | -tSizes=t.sizes -qSizes=q.sizes} "
              "-linearGap=loose|medium|file [options]", file=sys.stderr)
        return 255
    thresholds = {}
    if "LRfoldThreshold" in opts:
        thresholds["lr_fold_threshold"] = float(opts["LRfoldThreshold"])
    if "foldThreshold" in opts:
        thresholds["fold_threshold"] = float(opts["foldThreshold"])
    if "maxSuspectBases" in opts:
        thresholds["max_suspect_bases"] = float(opts["maxSuspectBases"])
    if "maxSuspectScore" in opts:
        thresholds["max_suspect_score"] = float(opts["maxSuspectScore"])
    if "minBrokenChainScore" in opts:
        thresholds["min_broken_chain_score"] = float(opts["minBrokenChainScore"])
    if "minLRGapSize" in opts:
        thresholds["min_lr_gap_size"] = int(opts["minLRGapSize"])
    if "doPairs" in opts:
        thresholds["do_pairs"] = True
    if "LRfoldThresholdPairs" in opts:
        thresholds["lr_fold_threshold_pairs"] = float(opts["LRfoldThresholdPairs"])
    if "maxPairDistance" in opts:
        thresholds["max_pair_distance"] = int(opts["maxPairDistance"])
    clean_chains(
        pos[0], pos[1], pos[2], pos[3], pos[4],
        net_file=opts.get("net"),
        t_sizes=opts.get("tSizes"), q_sizes=opts.get("qSizes"),
        linear_gap=opts.get("linearGap", "loose"),
        score_scheme=opts.get("scoreScheme"),
        new_chain_id_dict_path=opts.get("newChainIDDict"),
        num_shards=int(opts.get("numShards", 1)),
        shard=int(opts.get("shard", 0)),
        shard_out=opts.get("shardOut"),
        debug="debug" in opts,
        suspect_data_file=opts.get("suspectDataFile"),
        only_this_chr=opts.get("onlyThisChr"),
        only_this_start=int(opts.get("onlyThisStart", -1)),
        only_this_end=int(opts.get("onlyThisEnd", -1)),
        device=device,
        **thresholds)
    return 0


def merge_cleaner_shards(shard_paths: list[str], out_chain_path: str,
                         out_bed_path: str,
                         new_chain_id_dict_path: str | None = None) -> None:
    """Combine per-shard cleaner bundles into the canonical outputs.

    Byte-identical to a single-shard run for any shard count: removals are
    re-interleaved by their (break-list position, within-list sequence)
    tags - the single run's removal order - and new suspect chain ids are
    assigned in that global order starting at maxChainId+1
    (chainCleaner.c:1341).  Host-0 merge per SURVEY §5.8."""
    import json

    bundles = [json.load(open(p)) for p in shard_paths]
    bundles.sort(key=lambda b: b["shard"])
    base_id = max(b["max_chain_id"] for b in bundles)
    shard0 = bundles[0]
    if "passthrough" not in shard0:
        raise ValueError("shard 0 bundle (with passthrough chains) missing")

    removals = sorted((r for b in bundles for r in b["removals"]),
                      key=lambda r: (r[0], r[1]))
    bed_lines = []
    suspect_texts = []
    id_dict: list[tuple[int, int]] = []
    for g, (_pos, _seq, bed, old_id, text) in enumerate(removals):
        gid = base_id + g + 1
        bed_lines.append(bed)
        header, rest = text.split("\n", 1)
        header = header.rsplit(" ", 1)[0] + f" {gid}"
        suspect_texts.append(header + "\n" + rest)
        id_dict.append((gid, old_id))

    interest = sorted((t for b in bundles for t in b["interest"]),
                      key=lambda t: t[0])

    from ..formats.chain import read_chains, sort_chains_by_score, \
        write_chains
    full_text = (shard0["passthrough"] + "".join(suspect_texts)
                 + "".join(t for _pos, t in interest))
    chains = read_chains(io.StringIO(full_text))
    with open(out_bed_path, "w") as f:
        f.writelines(bed_lines)
    if new_chain_id_dict_path:
        with open(new_chain_id_dict_path, "w") as f:
            for new_id, old_id in id_dict:
                f.write(f"{new_id}\t{old_id}\n")
    with open(out_chain_path, "w") as outf:
        for line in shard0.get("meta", []):
            outf.write(line + "\n")
        write_chains(sort_chains_by_score(chains), outf)


def clean_chains_distributed(in_chain: str, t_2bit: str, q_2bit: str,
                             out_chain_path: str, out_bed_path: str,
                             work_dir: str, max_gather_bytes: int = 1 << 29,
                             **kw) -> None:
    """Multi-process chainCleaner: every torch.distributed rank runs its
    shard (on kw's `device`), bundles are gathered to every rank
    (parallel/distributed.host0_merge_text) and rank 0 merges them."""
    import os

    from ..parallel.distributed import host0_merge_text, world
    n, me = world()
    os.makedirs(work_dir, exist_ok=True)
    shard_path = os.path.join(work_dir, f"cleaner_shard_{me}.json")
    clean_chains(in_chain, t_2bit, q_2bit, out_chain_path, out_bed_path,
                 num_shards=n, shard=me, shard_out=shard_path, **kw)
    if n == 1:
        return
    # gather bundles (length-prefixed) to every process; 0 writes.  The
    # buffer cap must cover shard 0's bundle (it embeds the pass-through
    # chain text) - default 512 MB, configurable for larger inputs.
    with open(shard_path) as f:
        merged = host0_merge_text(f.read() + "\x00",
                                  max_bytes=max_gather_bytes)
    if me == 0:
        parts = [p for p in merged.split("\x00") if p]
        paths = []
        for i, text in enumerate(parts):
            pth = os.path.join(work_dir, f"gathered_{i}.json")
            with open(pth, "w") as f:
                f.write(text)
            paths.append(pth)
        merge_cleaner_shards(paths, out_chain_path, out_bed_path)
