"""chainNet engine: netting sweep + (optional) exact sub-net rescoring.

Behavioral reference: src/chainNet/chainNet.c (hillerlab-modified).  The
netting algorithm inserts chains in descending score order into per-chrom
"space" partitions (reference uses an rbTree of spaces; we keep a sorted
interval list - spaces are disjoint, so order-by-start is total):

  addChainT  (chainNet.c:557-608)  - target side
  addChainQ  (chainNet.c:610-679)  - query side, q coords flipped to + strand
  fillSpace  (chainNet.c:487-523)  - claim [s,e) inside a space, split rest
  strictlyInside (chainNet.c:321-326) - sub-gap eligibility
  finishNet  (chainNet.c:725-738)  - sort + compute other-side ranges
  subchainInfo (chainNet.c:795-843) - output score: approximation
      chain.score*subSize/fullSize, or with -rescore the exact
      chainSubsetOnT + chainCalcScore (negative scores clamped to 1,
      chainNet.c:244-245)

Output is byte-identical to the reference tool.  The exact-rescore path
batches all sub-chain scorings through the device kernel when a device
scorer is supplied.
"""

from __future__ import annotations

import sys
from bisect import bisect_left, insort
from dataclasses import dataclass, field

import numpy as np

from ..device import PERF
from ..device.genome import open_genome
from ..formats.chain import Chain, iter_chains
from ..formats.chromsizes import read_chrom_sizes
from ..formats.gapcalc import gap_calc_from_file
from ..formats.scorematrix import read_score_scheme, score_scheme_default
from .scoring import ChainScorer


@dataclass
class _Gap:
    start: int
    end: int
    o_start: int
    o_end: int
    fills: list = field(default_factory=list)  # head-insert order


@dataclass
class _Fill:
    start: int
    end: int
    chain: Chain
    o_start: int = 0
    o_end: int = 0
    gaps: list = field(default_factory=list)  # head-insert order


class _Space:
    __slots__ = ("start", "end", "gap", "dead")

    def __init__(self, start, end, gap):
        self.start = start
        self.end = end
        self.gap = gap
        self.dead = False

    def __lt__(self, other):
        return self.start < other.start


@dataclass
class _Chrom:
    name: str
    size: int
    root: _Gap
    spaces: list = field(default_factory=list)  # sorted disjoint _Space list

    def add_space(self, gap: _Gap, start=None, end=None):
        s = _Space(gap.start if start is None else start,
                   gap.end if end is None else end, gap)
        insort(self.spaces, s)
        return s

    def find_spaces(self, start: int, end: int) -> list[_Space]:
        """Spaces overlapping [start,end), in start order (findSpaces)."""
        out = []
        # first space with end > start: binary search on start is close
        # enough; scan back one in case of a space straddling `start`.
        i = bisect_left(self.spaces, _Space(start, start, None))
        if i > 0 and self.spaces[i - 1].end > start:
            i -= 1
        while i < len(self.spaces) and self.spaces[i].start < end:
            if self.spaces[i].end > start:
                out.append(self.spaces[i])
            i += 1
        return out

    def remove_space(self, space: _Space):
        i = bisect_left(self.spaces, space)
        while i < len(self.spaces):
            if self.spaces[i] is space:
                del self.spaces[i]
                return
            i += 1
        raise ValueError("space not found")

    def has_data(self) -> bool:
        return bool(self.root.fills)


def _inner_bounds(starts: np.ndarray, ends: np.ndarray, in_start: int,
                  in_end: int, min_fill: int):
    """innerBounds (chainNet.c:356-391): clipped span of blocks within
    [in_start, in_end), or None if too small."""
    lo = int(np.searchsorted(ends, in_start, side="right"))
    hi = int(np.searchsorted(starts, in_end, side="left"))
    if lo >= hi:
        return None
    s = max(int(starts[lo]), in_start)
    e = min(int(ends[hi - 1]), in_end)
    if e - s < min_fill:
        return None
    return s, e


class Netter:
    """One netting run (both sides), mirroring chainNet()."""

    def __init__(self, t_sizes: dict[str, int], q_sizes: dict[str, int],
                 min_space: int = 25, min_fill: int | None = None,
                 min_score: float = 2000, incl_hap: bool = False):
        self.min_space = min_space
        self.min_fill = min_space // 2 if min_fill is None else min_fill
        self.min_score = min_score
        self.incl_hap = incl_hap
        self.t_chroms = self._make_chroms(t_sizes)
        self.q_chroms = self._make_chroms(q_sizes)

    def _make_chroms(self, sizes: dict[str, int]) -> dict[str, _Chrom]:
        out = {}
        for name, size in sizes.items():
            root = _Gap(0, size, 0, 0)
            ch = _Chrom(name=name, size=size, root=root)
            ch.add_space(root)
            out[name] = ch
        return out

    # -- chain insertion ----------------------------------------------------
    def add_chain(self, chain: Chain) -> None:
        q = self.q_chroms.get(chain.q_name)
        t = self.t_chroms.get(chain.t_name)
        if q is None:
            raise KeyError(f"{chain.q_name} not in query sizes")
        if t is None:
            raise KeyError(f"{chain.t_name} not in target sizes")
        if q.size != chain.q_size:
            raise ValueError(f"{chain.q_name} size mismatch: {chain.q_size} vs {q.size}")
        if t.size != chain.t_size:
            raise ValueError(f"{chain.t_name} size mismatch: {chain.t_size} vs {t.size}")
        if not self.incl_hap and ("_hap" in chain.q_name or "_alt" in chain.q_name):
            return
        self._add_chain_q(q, chain)
        self._add_chain_t(t, chain)

    def _add_chain_t(self, chrom: _Chrom, chain: Chain) -> None:
        b = chain.blocks
        starts, ends = b[:, 0], b[:, 1]
        q_starts, q_ends = b[:, 2], b[:, 3]
        spaces = chrom.find_spaces(chain.t_start, chain.t_end)
        # sub-gap candidates between consecutive blocks
        gs = ends[:-1]
        ge = starts[1:]
        for space in spaces:
            se = _inner_bounds(starts, ends, space.start, space.end, self.min_fill)
            if se is None:
                continue
            s, e = se
            fill = _Fill(s, e, chain)
            self._claim_space(chrom, space, s, e)
            space.gap.fills.insert(0, fill)
            mask = (space.start < gs) & (gs + self.min_space <= ge) & (ge < space.end)
            for i in np.flatnonzero(mask):
                qs, qe = int(q_ends[i]), int(q_starts[i + 1])
                if chain.q_strand == "-":
                    qs, qe = chain.q_size - qe, chain.q_size - qs
                gap = _Gap(int(gs[i]), int(ge[i]), qs, qe)
                chrom.add_space(gap)
                fill.gaps.insert(0, gap)

    def _add_chain_q(self, chrom: _Chrom, chain: Chain) -> None:
        b = chain.blocks
        if chain.q_strand == "+":
            qb_qs, qb_qe = b[:, 2], b[:, 3]
            qb_ts, qb_te = b[:, 0], b[:, 1]
        else:
            # q-plus-strand order: reversed blocks, flipped q coords
            # (reverseBlocksQ, chainNet.c:547-554)
            rb = b[::-1]
            qb_qs = chain.q_size - rb[:, 3]
            qb_qe = chain.q_size - rb[:, 2]
            qb_ts, qb_te = rb[:, 0], rb[:, 1]
        q_start, q_end = int(qb_qs[0]), int(qb_qe[-1])
        spaces = chrom.find_spaces(q_start, q_end)
        gs = qb_qe[:-1]
        ge = qb_qs[1:]
        for space in spaces:
            se = _inner_bounds(qb_qs, qb_qe, space.start, space.end, self.min_fill)
            if se is None:
                continue
            s, e = se
            fill = _Fill(s, e, chain)
            self._claim_space(chrom, space, s, e)
            space.gap.fills.insert(0, fill)
            mask = (space.start < gs) & (gs + self.min_space <= ge) & (ge < space.end)
            for i in np.flatnonzero(mask):
                if chain.q_strand == "+":
                    ts, te = int(qb_te[i]), int(qb_ts[i + 1])
                else:
                    # reference quirk kept verbatim (chainNet.c:663-667):
                    # '-' strand o-range spans both flanking blocks
                    ts, te = int(qb_ts[i + 1]), int(qb_te[i])
                gap = _Gap(int(gs[i]), int(ge[i]), ts, te)
                chrom.add_space(gap)
                fill.gaps.insert(0, gap)

    def _claim_space(self, chrom: _Chrom, space: _Space, s: int, e: int):
        """fillSpace's space bookkeeping (chainNet.c:504-520)."""
        chrom.remove_space(space)
        if s - space.start >= self.min_space:
            chrom.add_space(space.gap, space.start, s)
        if space.end - e >= self.min_space:
            chrom.add_space(space.gap, e, space.end)

    # -- finishing ----------------------------------------------------------
    def finish(self) -> None:
        for chrom in self.q_chroms.values():
            if chrom.has_data():
                self._sort_net(chrom.root)
                self._r_calc_other(chrom.root, is_q=True)
        for chrom in self.t_chroms.values():
            if chrom.has_data():
                self._sort_net(chrom.root)
                self._r_calc_other(chrom.root, is_q=False)

    def _sort_net(self, gap: _Gap) -> None:
        gap.fills.sort(key=lambda f: f.start)
        for fill in gap.fills:
            fill.gaps.sort(key=lambda g: g.start)
            for g in fill.gaps:
                self._sort_net(g)

    def _r_calc_other(self, gap: _Gap, is_q: bool) -> None:
        for fill in gap.fills:
            if is_q:
                self._q_fill_other_range(fill)
            else:
                self._t_fill_other_range(fill)
            for g in fill.gaps:
                self._r_calc_other(g, is_q)

    def _t_fill_other_range(self, fill: _Fill) -> None:
        """tFillOtherRange (chainNet.c:441-484)."""
        chain = fill.chain
        b = chain.blocks
        clip_s, clip_e = fill.start, fill.end
        lo = int(np.searchsorted(b[:, 1], clip_s, side="right"))
        hi = int(np.searchsorted(b[:, 0], clip_e, side="left"))
        assert lo < hi, "tFillOtherRange: no overlapping blocks"
        ts = max(int(b[lo, 0]), clip_s)
        te = min(int(b[hi - 1, 1]), clip_e)
        qs = int(b[lo, 2]) + max(0, clip_s - int(b[lo, 0]))
        qe = int(b[hi - 1, 3]) - max(0, int(b[hi - 1, 1]) - clip_e)
        q_min = qs
        q_max = qe
        if chain.q_strand == "-":
            q_min, q_max = chain.q_size - q_max, chain.q_size - q_min
        fill.start, fill.end = ts, te
        fill.o_start, fill.o_end = q_min, q_max

    def _q_fill_other_range(self, fill: _Fill) -> None:
        """qFillOtherRange (chainNet.c:393-439)."""
        chain = fill.chain
        b = chain.blocks
        clip_s, clip_e = fill.start, fill.end
        if chain.q_strand == "-":
            clip_s, clip_e = chain.q_size - clip_e, chain.q_size - clip_s
        lo = int(np.searchsorted(b[:, 3], clip_s, side="right"))
        hi = int(np.searchsorted(b[:, 2], clip_e, side="left"))
        assert lo < hi, "qFillOtherRange: no overlapping blocks"
        qs = max(int(b[lo, 2]), clip_s)
        qe = min(int(b[hi - 1, 3]), clip_e)
        ts = int(b[lo, 0]) + max(0, clip_s - int(b[lo, 2]))
        te = int(b[hi - 1, 1]) - max(0, int(b[hi - 1, 3]) - clip_e)
        q_min, q_max = qs, qe
        if chain.q_strand == "-":
            q_min, q_max = chain.q_size - q_max, chain.q_size - q_min
        fill.start, fill.end = q_min, q_max
        fill.o_start, fill.o_end = ts, te

    # -- output -------------------------------------------------------------
    def _subchain_info(self, chain: Chain, start: int, end: int, is_q: bool,
                      rescorer) -> tuple[int, float]:
        return _subchain_info(chain, start, end, is_q, rescorer)

    def iter_fills(self, is_q: bool):
        """All fills on one side, output order (for batched rescoring)."""
        def walk(fill):
            yield fill
            for gap in fill.gaps:
                for sub in gap.fills:
                    yield from walk(sub)
        chroms = self.q_chroms if is_q else self.t_chroms
        for chrom in chroms.values():
            if not chrom.has_data():
                continue
            for fill in chrom.root.fills:
                yield from walk(fill)

    def output_side(self, out, is_q: bool, rescorer=None) -> int:
        """Write one side; returns the fill lines written."""
        chroms = self.q_chroms if is_q else self.t_chroms
        self._fills_out = 0
        for chrom in chroms.values():
            if not chrom.has_data():
                continue
            out.write(f"net {chrom.name} {chrom.size}\n")
            for fill in chrom.root.fills:
                self._out_fill(out, fill, 1, is_q, rescorer)
        return self._fills_out

    def _out_fill(self, out, fill: _Fill, depth: int, is_q: bool, rescorer):
        chain = fill.chain
        sub_size, sub_score = self._subchain_info(chain, fill.start, fill.end,
                                                  is_q, rescorer)
        if sub_score >= self.min_score and sub_size >= self.min_fill:
            self._fills_out += 1
            o_chrom = chain.t_name if is_q else chain.q_name
            out.write(" " * depth +
                      f"fill {fill.start} {fill.end - fill.start} {o_chrom} "
                      f"{chain.q_strand} {fill.o_start} "
                      f"{fill.o_end - fill.o_start} id {chain.id} "
                      f"score {sub_score:.0f} ali {sub_size}\n")
            for gap in fill.gaps:
                self._out_gap(out, fill, gap, depth + 1, is_q, rescorer)

    def _out_gap(self, out, parent: _Fill, gap: _Gap, depth: int, is_q: bool,
                 rescorer):
        chain = parent.chain
        o_chrom = chain.t_name if is_q else chain.q_name
        out.write(" " * depth +
                  f"gap {gap.start} {gap.end - gap.start} {o_chrom} "
                  f"{chain.q_strand} {gap.o_start} {gap.o_end - gap.o_start}\n")
        for fill in gap.fills:
            self._out_fill(out, fill, depth + 1, is_q, rescorer)


def _full_ali(chain: Chain) -> int:
    """Total aligned bases, memoized per chain (read-only after parse)."""
    v = getattr(chain, "_full_ali", None)
    if v is None:
        b = chain.blocks
        v = chain._full_ali = int((b[:, 1] - b[:, 0]).sum())
    return v


def _subchain_info(chain: Chain, start: int, end: int, is_q: bool,
                   rescorer) -> tuple[int, float]:
    """subchainInfo (chainNet.c:795-843): (subSize, subScore)."""
    b = chain.blocks
    full_size = _full_ali(chain)
    if is_q:
        if chain.q_strand == "-":
            start, end = chain.q_size - end, chain.q_size - start
        if start <= chain.q_start and end >= chain.q_end:
            return full_size, chain.score
        inter = np.minimum(b[:, 3], end) - np.maximum(b[:, 2], start)
        sub_size = int(np.maximum(inter, 0).sum())
        return sub_size, chain.score * sub_size / full_size
    if start <= chain.t_start and end >= chain.t_end:
        return full_size, chain.score
    inter = np.minimum(b[:, 1], end) - np.maximum(b[:, 0], start)
    sub_size = int(np.maximum(inter, 0).sum())
    if rescorer is not None:
        score = rescorer(chain, start, end)
        if score <= 0:
            score = 1.0
        return sub_size, score
    return sub_size, chain.score * sub_size / full_size


class _FillView:
    """Lightweight fill handle from the native net tree (rescore batching
    + writer share coordinates through this)."""
    __slots__ = ("chain", "start", "end")

    def __init__(self, chain, start, end):
        self.chain = chain
        self.start = start
        self.end = end


class NativeNetTree:
    """Net tree built by the native sweep (native/netsweep.cpp); exposes
    the same iter_fills/output_side surface as Netter.  Nodes are DFS
    (= output) order int64 rows [is_gap, depth, start, end, o_start,
    o_end, chain_idx]; a fill that fails the output thresholds prunes its
    whole subtree (rOutputFill, chainNet.c:858-878)."""

    def __init__(self, chains, t_names, t_sizes, q_names, q_sizes,
                 nodes_t, segs_t, nodes_q, segs_q,
                 min_space, min_fill, min_score,
                 blocks=None, block_off=None):
        self.chains = chains
        self.t_names, self.t_sizes = t_names, t_sizes
        self.q_names, self.q_sizes = q_names, q_sizes
        self.nodes_t, self.segs_t = nodes_t, segs_t
        self.nodes_q, self.segs_q = nodes_q, segs_q
        self.min_space = min_space
        self.min_fill = min_space // 2 if min_fill is None else min_fill
        self.min_score = min_score
        # concatenated chain blocks from the sweep, reused by the writer
        self._blocks = blocks
        self._block_off = block_off
        self._headers = None

    def _side(self, is_q):
        return ((self.nodes_q, self.segs_q, self.q_names, self.q_sizes)
                if is_q else
                (self.nodes_t, self.segs_t, self.t_names, self.t_sizes))

    def iter_fills(self, is_q: bool):
        for _i, view in self.iter_fills_idx(is_q):
            yield view

    def iter_fills_idx(self, is_q: bool):
        """(node_index, _FillView) pairs - node_index keys the
        score_override array of output_side."""
        nodes, _, _, _ = self._side(is_q)
        fill_rows = np.flatnonzero(nodes[:, 0] == 0)
        chains = self.chains
        for i in fill_rows:
            row = nodes[i]
            yield int(i), _FillView(chains[int(row[6])], int(row[2]),
                                    int(row[3]))

    def _chain_arrays(self):
        """(blocks, block_off, headers, strands, ids, scores) cached."""
        if self._headers is None:
            chains = self.chains
            n = len(chains)
            if self._blocks is None:
                block_off = np.zeros(n + 1, np.int64)
                for i, c in enumerate(chains):
                    block_off[i + 1] = block_off[i] + c.n_blocks
                from ..utils.bigmem import big_empty
                blocks = big_empty((int(block_off[-1]), 4), np.int64)
                for i, c in enumerate(chains):
                    np.copyto(blocks[block_off[i]:block_off[i + 1]],
                              c.blocks)
                self._blocks, self._block_off = blocks, block_off
            headers = np.empty((n, 5), np.int64)
            strands = np.empty(n, np.uint8)
            ids = np.empty(n, np.int64)
            scores = np.empty(n, np.float64)
            for i, c in enumerate(chains):
                headers[i] = (c.t_start, c.t_end, c.q_start, c.q_end,
                              c.q_size)
                strands[i] = ord(c.q_strand)
                ids[i] = c.id
                scores[i] = c.score
            self._headers = (headers, strands, ids, scores)
        return (self._blocks, self._block_off) + self._headers

    def _native_write(self, lib, is_q: bool, score_override) -> memoryview:
        """Serialize one side via gat_net_write (native/netwrite.cpp)."""
        import ctypes
        nodes_arr, segs, names, sizes = self._side(is_q)
        blocks, block_off, headers, strands, ids, scores = \
            self._chain_arrays()
        chains = self.chains
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)

        def blob_of(strs):
            off = np.zeros(len(strs) + 1, np.int64)
            parts = []
            for i, s in enumerate(strs):
                b = s.encode()
                parts.append(b)
                off[i + 1] = off[i] + len(b)
            return b"".join(parts), off

        chrom_blob, chrom_off = blob_of(names)
        attr = "_onames_q" if is_q else "_onames_t"
        cached = getattr(self, attr, None)
        if cached is None:
            cached = blob_of([c.t_name if is_q else c.q_name
                              for c in chains])
            setattr(self, attr, cached)
        oname_blob, oname_off = cached
        sizes_arr = np.asarray(sizes, np.int64)
        nodes_c = np.ascontiguousarray(nodes_arr, np.int64)
        segs_c = np.ascontiguousarray(segs, np.int64)
        if score_override is not None:
            ov = np.ascontiguousarray(score_override, np.float64)
            ov_p = ov.ctypes.data_as(f64p)
        else:
            ov_p = ctypes.cast(None, f64p)
        out_len = ctypes.c_int64()
        p = lib.gat_net_write(
            nodes_c.ctypes.data_as(i64p), nodes_c.shape[0],
            segs_c.ctypes.data_as(i64p), segs_c.shape[0],
            chrom_blob, chrom_off.ctypes.data_as(i64p),
            sizes_arr.ctypes.data_as(i64p),
            oname_blob, oname_off.ctypes.data_as(i64p),
            strands.ctypes.data_as(u8p), ids.ctypes.data_as(i64p),
            scores.ctypes.data_as(f64p),
            headers.ctypes.data_as(i64p),
            blocks.ctypes.data_as(i64p), block_off.ctypes.data_as(i64p),
            len(chains),
            ov_p,
            float(self.min_score), int(self.min_fill), int(is_q),
            ctypes.byref(out_len))
        try:
            from ..utils.bigmem import big_empty
            out = big_empty(out_len.value, np.uint8)
            ctypes.memmove(out.ctypes.data, p, out_len.value)
            return memoryview(out).cast("B")
        finally:
            lib.gat_free_buffer(p)

    def output_side(self, out, is_q: bool, rescorer=None,
                    score_override=None) -> int:
        """Write one side; returns the fill lines written."""
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "gat_net_write") and \
                (rescorer is None or score_override is not None):
            mv = self._native_write(lib, is_q, score_override)
            import io as _io
            buf = getattr(out, "buffer", None)
            if buf is not None:  # text wrapper over a binary stream
                out.flush()
                buf.write(mv)
            elif isinstance(out, (_io.RawIOBase, _io.BufferedIOBase)):
                out.write(mv)  # binary sink: zero-copy
            else:
                out.write(bytes(mv).decode())
            nodes, segs = self._side(is_q)[:2]
            return _fill_lines(mv, nodes, len(segs))
        nodes_arr, segs, names, sizes = self._side(is_q)
        nodes = nodes_arr.tolist()  # plain ints: ~5x faster walk
        chains = self.chains
        fills = 0
        parts: list[str] = []
        app = parts.append
        for ci, lo, hi in segs:
            app(f"net {names[ci]} {sizes[ci]}\n")
            i = int(lo)
            hi = int(hi)
            while i < hi:
                is_gap, depth, s, e, os_, oe, cidx = nodes[i]
                chain = chains[cidx]
                o_chrom = chain.t_name if is_q else chain.q_name
                if is_gap:
                    app(" " * depth +
                        f"gap {s} {e - s} {o_chrom} {chain.q_strand} "
                        f"{os_} {oe - os_}\n")
                    i += 1
                    continue
                sub_size, sub_score = _subchain_info(
                    chain, s, e, is_q, rescorer)
                if sub_score >= self.min_score and sub_size >= self.min_fill:
                    fills += 1
                    app(" " * depth +
                        f"fill {s} {e - s} {o_chrom} {chain.q_strand} "
                        f"{os_} {oe - os_} id {chain.id} "
                        f"score {sub_score:.0f} ali {sub_size}\n")
                    i += 1
                else:  # prune the whole subtree
                    j = i + 1
                    while j < hi and nodes[j][1] > depth:
                        j += 1
                    i = j
            if len(parts) > 65536:
                out.write("".join(parts))
                parts = []
                app = parts.append
        out.write("".join(parts))
        return fills


def _fill_lines(text, nodes: np.ndarray, n_nets: int) -> int:
    """The fill lines of one side's net text as the native writer wrote it
    from `nodes`: every fill node, unless a fill failed the output
    thresholds and took its subtree with it (then counted by depth)."""
    fills = nodes[:, 0] == 0
    data = np.frombuffer(text, np.uint8)
    if int(np.count_nonzero(data == 10)) == n_nets + nodes.shape[0]:
        return int(np.count_nonzero(fills))
    raw = bytes(text)
    return sum(raw.count(b"\n" + b" " * int(d) + b"fill ")
               for d in np.unique(nodes[fills, 1]))


class LazyChains:
    """Sequence facade over a ChainTable (+ row subset): materializes
    python Chain objects only for the rows actually touched."""

    __slots__ = ("table", "sel", "_cache")

    def __init__(self, table, sel):
        self.table = table
        self.sel = sel
        self._cache: dict[int, Chain] = {}

    def __len__(self):
        return int(self.sel.shape[0])

    def __getitem__(self, i: int) -> Chain:
        c = self._cache.get(i)
        if c is None:
            c = self._cache[i] = self.table.materialize(int(self.sel[i]))
        return c

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _gather_blocks(table, sel):
    """(blocks, block_off) for the selected rows (vectorized gather)."""
    bo = table.block_offsets
    cnt = bo[sel + 1] - bo[sel]
    block_off = np.zeros(sel.shape[0] + 1, np.int64)
    np.cumsum(cnt, out=block_off[1:])
    if sel.shape[0] == len(table) and np.array_equal(sel,
                                                     np.arange(len(table))):
        return np.ascontiguousarray(table.blocks), bo.copy()
    total = int(block_off[-1])
    if total == 0:
        return np.zeros((0, 4), np.int64), block_off
    # standard segmented gather: positions = repeat(starts - prefix) + arange
    pos = np.repeat(bo[sel] - block_off[:-1], cnt) + np.arange(total)
    return np.ascontiguousarray(table.blocks[pos]), block_off


def _native_net_tree_table(table, sel, t_sizes: dict, q_sizes: dict,
                           min_space: int, min_fill: int | None,
                           min_score: float,
                           incl_hap: bool,
                           sides: int = 3) -> "NativeNetTree | None":
    """_native_net_tree over a ChainTable + row selection: all array prep
    is vectorized; python Chain objects are only materialized lazily for
    rows a caller actually touches (rescore fills / fallback writer)."""
    import ctypes

    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    (t_fac_ids, t_fac_names), (q_fac_ids, q_fac_names) = \
        table.names_factorized()
    t_names = list(t_sizes)
    q_names = list(q_sizes)
    t_idx = {n: i for i, n in enumerate(t_names)}
    q_idx = {n: i for i, n in enumerate(q_names)}
    # per-unique-name validation (mirrors the per-chain checks of the
    # object path; same error messages)
    t_map = np.empty(len(t_fac_names), np.int32)
    for j, nm in enumerate(t_fac_names):
        if nm not in t_idx:
            if np.isin(np.flatnonzero(t_fac_ids == j), sel).any():
                raise KeyError(f"{nm} not in target sizes")
            t_map[j] = -1
            continue
        t_map[j] = t_idx[nm]
    q_map = np.empty(len(q_fac_names), np.int32)
    hap = np.zeros(len(q_fac_names), bool)
    for j, nm in enumerate(q_fac_names):
        hap[j] = "_hap" in nm or "_alt" in nm
        if nm not in q_idx:
            if np.isin(np.flatnonzero(q_fac_ids == j), sel).any():
                raise KeyError(f"{nm} not in query sizes")
            q_map[j] = -1
            continue
        q_map[j] = q_idx[nm]
    # size mismatch checks (vectorized over selected rows)
    t_sz_arr = np.array([t_sizes.get(nm, -1) for nm in t_fac_names],
                        np.int64)
    q_sz_arr = np.array([q_sizes.get(nm, -1) for nm in q_fac_names],
                        np.int64)
    h = table.header
    bad_q = sel[q_sz_arr[q_fac_ids[sel]] != h[sel, 3]]
    if bad_q.size:
        i = int(bad_q[0])
        nm = q_fac_names[q_fac_ids[i]]
        raise ValueError(f"{nm} size mismatch: "
                         f"{int(h[i, 3])} vs {q_sizes[nm]}")
    bad_t = sel[t_sz_arr[t_fac_ids[sel]] != h[sel, 0]]
    if bad_t.size:
        i = int(bad_t[0])
        nm = t_fac_names[t_fac_ids[i]]
        raise ValueError(f"{nm} size mismatch: "
                         f"{int(h[i, 0])} vs {t_sizes[nm]}")
    if not incl_hap:
        sel = sel[~hap[q_fac_ids[sel]]]

    n = int(sel.shape[0])
    t_ci = np.ascontiguousarray(t_map[t_fac_ids[sel]], np.int32)
    q_ci = np.ascontiguousarray(q_map[q_fac_ids[sel]], np.int32)
    minus = np.ascontiguousarray(table.strands[sel] == ord("-"), np.uint8)
    t_bounds = np.ascontiguousarray(h[sel][:, 1:3], np.int64)
    blocks, block_off = _gather_blocks(table, sel)
    t_sz = np.array([t_sizes[nm] for nm in t_names], np.int64)
    q_sz = np.array([q_sizes[nm] for nm in q_names], np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    res_p = lib.gat_net_sweep_sides(
        n, t_ci.ctypes.data_as(i32p), q_ci.ctypes.data_as(i32p),
        minus.ctypes.data_as(u8p),
        t_bounds.ctypes.data_as(i64p),
        block_off.ctypes.data_as(i64p), blocks.ctypes.data_as(i64p),
        len(t_names), t_sz.ctypes.data_as(i64p),
        len(q_names), q_sz.ctypes.data_as(i64p),
        min_space, min_space // 2 if min_fill is None else min_fill,
        sides)
    try:
        res = res_p.contents
        err = bytes(res.error).split(b"\0")[0]
        if err:
            raise AssertionError(err.decode())

        def grab(ptr, count, width):
            if count == 0:
                return np.zeros((0, width), np.int64)
            return np.ctypeslib.as_array(ptr, shape=(count, width)).copy()

        nodes_t = grab(res.t_nodes, res.t_n_nodes, 7)
        segs_t = grab(res.t_chrom_seg, res.t_n_chroms, 3)
        nodes_q = grab(res.q_nodes, res.q_n_nodes, 7)
        segs_q = grab(res.q_chrom_seg, res.q_n_chroms, 3)
    finally:
        lib.gat_net_free(res_p)
    nt = NativeNetTree(LazyChains(table, sel), t_names,
                       [t_sizes[nm] for nm in t_names],
                       q_names, [q_sizes[nm] for nm in q_names],
                       nodes_t, segs_t, nodes_q, segs_q,
                       min_space, min_fill, min_score,
                       blocks=blocks, block_off=block_off)
    # feed the writer's per-chain arrays straight from the table
    headers = np.ascontiguousarray(h[sel][:, [1, 2, 4, 5, 3]], np.int64)
    strands = np.ascontiguousarray(table.strands[sel])
    ids = np.ascontiguousarray(h[sel, 6], np.int64)
    scores = np.ascontiguousarray(table.scores[sel], np.float64)
    nt._headers = (headers, strands, ids, scores)
    # other-side name blob (q names for the t-side writer and vice versa)
    for attr, fac_ids, fac_names in (("_onames_t", q_fac_ids, q_fac_names),
                                     ("_onames_q", t_fac_ids, t_fac_names)):
        name_bytes = [nm.encode() for nm in fac_names]
        lens = np.array([len(b) for b in name_bytes], np.int64)
        row_ids = fac_ids[sel]
        off = np.zeros(n + 1, np.int64)
        np.cumsum(lens[row_ids], out=off[1:])
        blob = b"".join([name_bytes[j] for j in row_ids])
        setattr(nt, attr, (blob, off))
    return nt


def _native_net_tree(chains, t_sizes: dict, q_sizes: dict, min_space: int,
                     min_fill: int | None, min_score: float,
                     incl_hap: bool) -> "NativeNetTree | None":
    """Run the native sweep over pre-validated chains; None if the native
    library is unavailable."""
    import ctypes

    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    t_names = list(t_sizes)
    q_names = list(q_sizes)
    t_idx = {n: i for i, n in enumerate(t_names)}
    q_idx = {n: i for i, n in enumerate(q_names)}
    added = []
    for chain in chains:
        if chain.q_name not in q_idx:
            raise KeyError(f"{chain.q_name} not in query sizes")
        if chain.t_name not in t_idx:
            raise KeyError(f"{chain.t_name} not in target sizes")
        if q_sizes[chain.q_name] != chain.q_size:
            raise ValueError(f"{chain.q_name} size mismatch: "
                             f"{chain.q_size} vs {q_sizes[chain.q_name]}")
        if t_sizes[chain.t_name] != chain.t_size:
            raise ValueError(f"{chain.t_name} size mismatch: "
                             f"{chain.t_size} vs {t_sizes[chain.t_name]}")
        if not incl_hap and ("_hap" in chain.q_name or "_alt" in chain.q_name):
            continue
        added.append(chain)

    n = len(added)
    t_ci = np.array([t_idx[c.t_name] for c in added], np.int32)
    q_ci = np.array([q_idx[c.q_name] for c in added], np.int32)
    minus = np.array([c.q_strand == "-" for c in added], np.uint8)
    t_bounds = np.array([[c.t_start, c.t_end] for c in added],
                        np.int64).reshape(n, 2)
    block_off = np.zeros(n + 1, np.int64)
    for i, c in enumerate(added):
        block_off[i + 1] = block_off[i] + c.n_blocks
    blocks = (np.concatenate([c.blocks for c in added])
              if added else np.zeros((0, 4))).astype(np.int64)
    blocks = np.ascontiguousarray(blocks)
    t_sz = np.array([t_sizes[nm] for nm in t_names], np.int64)
    q_sz = np.array([q_sizes[nm] for nm in q_names], np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    res_p = lib.gat_net_sweep(
        n, t_ci.ctypes.data_as(i32p), q_ci.ctypes.data_as(i32p),
        minus.ctypes.data_as(u8p),
        np.ascontiguousarray(t_bounds).ctypes.data_as(i64p),
        block_off.ctypes.data_as(i64p), blocks.ctypes.data_as(i64p),
        len(t_names), t_sz.ctypes.data_as(i64p),
        len(q_names), q_sz.ctypes.data_as(i64p),
        min_space, min_space // 2 if min_fill is None else min_fill)
    try:
        res = res_p.contents
        err = bytes(res.error).split(b"\0")[0]
        if err:
            raise AssertionError(err.decode())

        def grab(ptr, count, width):
            if count == 0:
                return np.zeros((0, width), np.int64)
            return np.ctypeslib.as_array(
                ptr, shape=(count, width)).copy()

        nodes_t = grab(res.t_nodes, res.t_n_nodes, 7)
        segs_t = grab(res.t_chrom_seg, res.t_n_chroms, 3)
        nodes_q = grab(res.q_nodes, res.q_n_nodes, 7)
        segs_q = grab(res.q_chrom_seg, res.q_n_chroms, 3)
    finally:
        lib.gat_net_free(res_p)
    return NativeNetTree(added, t_names, [t_sizes[nm] for nm in t_names],
                         q_names, [q_sizes[nm] for nm in q_names],
                         nodes_t, segs_t, nodes_q, segs_q,
                         min_space, min_fill, min_score,
                         blocks=blocks, block_off=block_off)


def net_tree_t_for_table(table, t_sizes_file: str, q_sizes_file: str,
                         min_space: int = 25, min_fill: int | None = None,
                         min_score: float = 0,
                         incl_hap: bool = False) -> "NativeNetTree | None":
    """Target-side-only native sweep over a ChainTable, WITHOUT the text
    writer - for chainCleaner's fused netting->filter->breaks path
    (gat_breaks_from_sweep).  Mirrors chain_net()'s prep: score-sort
    check (chainNet.c:945-946) and min_score cutoff.  None when the
    native library is unavailable."""
    t_sizes = read_chrom_sizes(t_sizes_file)
    q_sizes = read_chrom_sizes(q_sizes_file)
    scores = table.scores
    if scores.shape[0] and np.any(np.diff(scores) > 0):
        raise ValueError("input chains must be sorted in order of score")
    below = np.flatnonzero(scores < min_score)
    cutoff = int(below[0]) if below.size else scores.shape[0]
    return _native_net_tree_table(
        table, np.arange(cutoff), t_sizes, q_sizes, min_space=min_space,
        min_fill=min_fill, min_score=min_score, incl_hap=incl_hap,
        sides=1)


def chain_net(chain_file: str, t_sizes_file: str, q_sizes_file: str,
              t_net_out, q_net_out,
              min_space: int = 25, min_fill: int | None = None,
              min_score: float = 2000, incl_hap: bool = False,
              rescore: bool = False, t_2bit: str | None = None,
              q_2bit: str | None = None, linear_gap: str | None = None,
              score_scheme: str | None = None, scorer_factory=None,
              num_shards: int = 1, shard: int = 0, device=None) -> None:
    """Run the full chainNet pipeline (mirrors chainNet.c:918-1002).

    device: where -rescore scores when no scorer_factory is given (cuda
    unless named, which raises without CUDA; ops/rescore.py).

    num_shards/shard: per-side chromosome partition (contiguous in
    sizes-file order).  Each side of the net is independent per chromosome
    (fills only claim space on their own chromosome), so concatenating the
    shard outputs in shard order is byte-identical to a single run."""
    if rescore:
        min_score = 0
        if t_2bit is None or q_2bit is None:
            raise ValueError("-rescore requires target and query genome files")
        if linear_gap is None:
            raise ValueError("-rescore requires -linearGap")
        scheme = (read_score_scheme(score_scheme) if score_scheme
                  else score_scheme_default())
        gap_calc = gap_calc_from_file(linear_gap)
        if scorer_factory is None:
            from ..ops.rescore import torch_scorer_factory
            scorer_factory = torch_scorer_factory(device)
        factory = scorer_factory or ChainScorer
        scorer = factory(scheme, gap_calc, open_genome(t_2bit),
                         open_genome(q_2bit))

        def rescorer(chain: Chain, start: int, end: int) -> float:
            PERF["chainnet_rescored_fills"] += 1
            PERF["chainnet_subsets_python"] += 1
            return scorer.global_score(chain.subset_on_t(start, end))
    else:
        rescorer = None

    from ..utils.profiling import phase
    with phase("chainnet: parse"):
        t_sizes = read_chrom_sizes(t_sizes_file)
        q_sizes = read_chrom_sizes(q_sizes_file)
        from ..formats.chain import read_chains
        from ..native.chain_io import ChainTable
        table = None
        if isinstance(chain_file, ChainTable):  # SoA path (chainCleaner shares)
            table = chain_file
        elif isinstance(chain_file, list):  # pre-parsed (chainCleaner shares)
            all_chains = chain_file
        elif isinstance(chain_file, str):
            from ..native.chain_io import parse_chain_table
            try:
                if chain_file.endswith(".gz"):
                    import gzip as _gz
                    with _gz.open(chain_file, "rb") as fh:
                        _data = fh.read()
                else:
                    with open(chain_file, "rb") as fh:
                        _data = fh.read()
                table = parse_chain_table(_data)
                del _data
            except OSError:
                table = None
            if table is None:
                all_chains = read_chains(chain_file)
        else:
            all_chains = list(iter_chains(chain_file))
        if table is not None:
            scores = table.scores
            if scores.shape[0] and np.any(np.diff(scores) > 0):
                raise ValueError("input chains must be sorted in order of score")
            below = np.flatnonzero(scores < min_score)
            cutoff = int(below[0]) if below.size else scores.shape[0]
            kept_sel = np.arange(cutoff)

            def build_netter_table(sel, sides=3):
                nt = _native_net_tree_table(
                    table, sel, t_sizes, q_sizes, min_space=min_space,
                    min_fill=min_fill, min_score=min_score, incl_hap=incl_hap,
                    sides=sides)
                if nt is None:
                    return build_netter([table.materialize(int(i))
                                         for i in sel])
                return nt
        else:
            last_score = -1.0
            kept: list[Chain] = []
            for chain in all_chains:
                if last_score >= 0 and chain.score > last_score:
                    raise ValueError(
                        "input chains must be sorted in order of score")
                last_score = chain.score
                if chain.score < min_score:
                    break
                kept.append(chain)

    def build_netter(chains):
        nt = _native_net_tree(chains, t_sizes, q_sizes, min_space=min_space,
                              min_fill=min_fill, min_score=min_score,
                              incl_hap=incl_hap)
        if nt is None:  # pure-python fallback (bit-identical)
            nt = Netter(t_sizes, q_sizes, min_space=min_space,
                        min_fill=min_fill, min_score=min_score,
                        incl_hap=incl_hap)
            for chain in chains:
                nt.add_chain(chain)
            nt.finish()
        return nt

    with phase("chainnet: net sweep"):
        q_netter = None
        if num_shards > 1:
            # per-side chromosome shard: the sweep only needs the chains that
            # live on this shard's chromosomes for the side being emitted
            from ..parallel.distributed import shard_indices
            t_names = list(t_sizes)
            q_names = list(q_sizes)
            t_idx = shard_indices(len(t_names), num_shards, shard)
            q_idx = shard_indices(len(q_names), num_shards, shard)
            my_t = set(t_names[t_idx.start:t_idx.stop])
            my_q = set(q_names[q_idx.start:q_idx.stop])
            if table is not None:
                (t_fac_ids, t_fac_names), (q_fac_ids, q_fac_names) = \
                    table.names_factorized()
                t_in = np.array([nm in my_t for nm in t_fac_names], bool)
                q_in = np.array([nm in my_q for nm in q_fac_names], bool)
                netter = build_netter_table(kept_sel[t_in[t_fac_ids[kept_sel]]],
                                            sides=1)
                if q_net_out is not None:
                    q_netter = build_netter_table(
                        kept_sel[q_in[q_fac_ids[kept_sel]]], sides=2)
            else:
                netter = build_netter([c for c in kept if c.t_name in my_t])
                if q_net_out is not None:
                    q_netter = build_netter(
                        [c for c in kept if c.q_name in my_q])
        elif table is not None:
            netter = build_netter_table(
                kept_sel, sides=3 if q_net_out is not None else 1)
            q_netter = netter
        else:
            netter = build_netter(kept)
            q_netter = netter
    with phase("chainnet: rescore fills"):
        t_override = None
        if rescorer is not None and hasattr(scorer, "score_chains"):
            # exact sub-net rescoring, fully batched: every fill's target-side
            # sub-chain is cut on host and the whole set is scored in one
            # device round trip (the -rescore hook, chainNet.c:832-835, is
            # per-fill sequential in the reference)
            native_tree = isinstance(netter, NativeNetTree)
            if native_tree and isinstance(netter.chains, LazyChains) and \
                    hasattr(scorer, "score_subsets"):
                # table path: every non-full-cover fill becomes one
                # (chain_row, start, end) job, cut and scored by the scorer
                # from the table's arrays; no python Chain/subset objects
                nodes = netter.nodes_t
                fill_idx = np.flatnonzero(nodes[:, 0] == 0)
                cidx = nodes[fill_idx, 6]
                s_arr = nodes[fill_idx, 2]
                e_arr = nodes[fill_idx, 3]
                headers = netter._chain_arrays()[2]  # (tS,tE,qS,qE,qSize)
                partial = ~((s_arr <= headers[cidx, 0])
                            & (e_arr >= headers[cidx, 1]))
                jobs = np.stack([cidx[partial], s_arr[partial],
                                 e_arr[partial]], axis=1)
                chains_fac = netter.chains  # LazyChains over (table, sel)
                out = scorer.score_subsets(chains_fac.table, chains_fac.sel,
                                           netter._blocks, netter._block_off,
                                           jobs)
                PERF["chainnet_subsets_table"] += int(jobs.shape[0])
                t_override = np.full(nodes.shape[0], np.nan)
                exists = out[:, 3] != 0
                t_override[fill_idx[partial][exists]] = \
                    out[exists, 0].astype(np.float64)
                PERF["chainnet_rescored_fills"] += int(exists.sum())

                def rescorer(chain: Chain, start: int, end: int) -> float:
                    return scorer.global_score(chain.subset_on_t(start, end))
            else:
                jobs = []
                keys: list[tuple[int, int, int]] = []
                idxs: list[int] = []
                fill_iter = (netter.iter_fills_idx(is_q=False) if native_tree
                             else ((None, f)
                                   for f in netter.iter_fills(is_q=False)))
                for idx, fill in fill_iter:
                    chain = fill.chain
                    if fill.start <= chain.t_start and fill.end >= chain.t_end:
                        continue  # full cover: chain.score is used directly
                    sub = chain.subset_on_t(fill.start, fill.end)
                    PERF["chainnet_subsets_python"] += 1
                    if sub is None:
                        continue
                    jobs.append(sub)
                    keys.append((chain, fill.start, fill.end))
                    idxs.append(idx)
                scored = scorer.score_chains(jobs)
                PERF["chainnet_rescored_fills"] += len(jobs)
                if native_tree:
                    # node-indexed score overrides feed the native writer
                    t_override = np.full(netter.nodes_t.shape[0], np.nan)
                    for idx, s_ in zip(idxs, scored):
                        t_override[idx] = s_[0]
                # key on (id, start, end) but pin the chain object in the value
                # so a GC'd chain can never alias a reused id()
                by_key = {(id(c), s, e): (c, s_[0])
                          for (c, s, e), s_ in zip(keys, scored)}

                def rescorer(chain: Chain, start: int, end: int,
                             _by_key=by_key) -> float:
                    hit = _by_key.get((id(chain), start, end))
                    if hit is not None and hit[0] is chain:
                        return hit[1]
                    return scorer.global_score(chain.subset_on_t(start, end))
    with phase("chainnet: write"):
        if isinstance(netter, NativeNetTree):
            import os as _os
            if (q_net_out is not None and q_netter is netter
                    and q_net_out is not t_net_out
                    and _os.environ.get("GAT_THREADS") != "1"):
                # the two side writers are independent reads over the same
                # tree and each native gat_net_write call releases the GIL:
                # overlap them (shared caches built up front so the worker
                # thread only reads)
                import threading as _threading
                netter._chain_arrays()
                q_err: list[BaseException] = []

                def _q_side():
                    try:
                        q_netter.output_side(q_net_out, is_q=True,
                                             rescorer=None)
                    except BaseException as e:  # re-raised on the main thread
                        q_err.append(e)

                th = _threading.Thread(target=_q_side)
                th.start()
                PERF["chainnet_fills"] += netter.output_side(
                    t_net_out, is_q=False, rescorer=rescorer,
                    score_override=t_override)
                th.join()
                if q_err:
                    raise q_err[0]
            else:
                PERF["chainnet_fills"] += netter.output_side(
                    t_net_out, is_q=False, rescorer=rescorer,
                    score_override=t_override)
                if q_net_out is not None:
                    q_netter.output_side(q_net_out, is_q=True, rescorer=None)
        else:
            PERF["chainnet_fills"] += netter.output_side(
                t_net_out, is_q=False, rescorer=rescorer)
            if q_net_out is not None:
                q_netter.output_side(q_net_out, is_q=True, rescorer=None)


def chain_net_main(argv: list[str], device=None) -> int:
    from ..cli.main import _parse_kent_args
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 5:
        print("usage: chainNet in.chain target.sizes query.sizes target.net "
              "query.net [-minSpace=N] [-minFill=N] [-minScore=N] [-inclHap] "
              "[-rescore -tNibDir=t.2bit -qNibDir=q.2bit -linearGap=...] "
              "[-numShards=N -shard=I]",
              file=sys.stderr)
        return 255
    t_out = sys.stdout if pos[3] == "stdout" else open(pos[3], "w")
    q_out = sys.stdout if pos[4] == "stdout" else open(pos[4], "w")
    if pos[3] == "/dev/null":
        pass
    try:
        chain_net(
            pos[0], pos[1], pos[2], t_out, q_out,
            min_space=int(opts.get("minSpace", 25)),
            min_fill=int(opts["minFill"]) if "minFill" in opts else None,
            min_score=int(opts.get("minScore", 2000)),
            incl_hap="inclHap" in opts,
            rescore="rescore" in opts,
            t_2bit=opts.get("tNibDir"),
            q_2bit=opts.get("qNibDir"),
            linear_gap=opts.get("linearGap"),
            score_scheme=opts.get("scoreScheme"),
            num_shards=int(opts.get("numShards", 1)),
            shard=int(opts.get("shard", 0)),
            device=device,
        )
    finally:
        if t_out is not sys.stdout:
            t_out.close()
        if q_out is not sys.stdout:
            q_out.close()
    return 0
