"""The stock kent net tool-suite.

Behavioral references (kent/src/hg/mouseStuff/):
  netSyntenic.c - qDup (depth>=2 coverage) + top/syn/inv/nonSyn typing
  netFilter.c   - recursive predicate / synteny filters
  netToBed.c    - net target coverage -> BED
  netSplit.c    - split net by chromosome
  netToAxt.c    - net + chains -> axt (split at child inserts)

Byte-compatible with the C tools.
"""

from __future__ import annotations

import os

import numpy as np

from ..formats.chain import Chain, iter_chains
from ..formats.net import Net, NetFill, read_nets, write_nets
from .chain_tools import _CharGenome, chain_to_axt_records, _is_haplotype

BIGNUM = 0x3FFFFFFF


# ---------------------------------------------------------------------------
# netSyntenic
# ---------------------------------------------------------------------------

class _CoverageMap:
    """Per-qChrom coverage from +1 (fills) / -1 (gaps) events; answers
    "bases with depth >= 2 in [start,end)" (netSyntenic's dupeTree)."""

    def __init__(self):
        self.events: dict[str, list[tuple[int, int]]] = {}
        self._built: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def add(self, name: str, start: int, end: int, direction: int):
        if start == end:
            return
        ev = self.events.setdefault(name, [])
        ev.append((start, direction))
        ev.append((end, -direction))

    def _build(self, name: str):
        if name in self._built:
            return self._built[name]
        ev = self.events.get(name, [])
        if not ev:
            out = (np.zeros(1, np.int64), np.zeros(1, np.int64))
            self._built[name] = out
            return out
        pos = np.array([e[0] for e in ev], np.int64)
        delta = np.array([e[1] for e in ev], np.int64)
        order = np.argsort(pos, kind="stable")
        pos, delta = pos[order], delta[order]
        upos, inv = np.unique(pos, return_inverse=True)
        agg = np.zeros(upos.shape[0], np.int64)
        np.add.at(agg, inv, delta)
        depth = np.cumsum(agg)  # depth in [upos[i], upos[i+1])
        seg_len = np.diff(np.concatenate([upos, [upos[-1]]]))
        dup_len = np.where(depth[:-1] >= 2, np.diff(upos), 0) \
            if upos.shape[0] > 1 else np.zeros(0, np.int64)
        dup_prefix = np.concatenate([[0], np.cumsum(dup_len)])
        out = (upos, depth, dup_prefix)
        self._built[name] = out
        return out

    def count_dup(self, name: str, start: int, end: int) -> int:
        built = self._build(name)
        if len(built) == 2:
            return 0
        upos, depth, dup_prefix = built
        if upos.shape[0] < 2:
            return 0
        # clip query to breakpoint grid
        lo = int(np.searchsorted(upos, start, side="right")) - 1
        hi = int(np.searchsorted(upos, end, side="left"))
        total = 0
        for i in range(max(lo, 0), min(hi, upos.shape[0] - 1)):
            if depth[i] >= 2:
                s = max(int(upos[i]), start)
                e = min(int(upos[i + 1]), end)
                if e > s:
                    total += e - s
        return total


def net_syntenic(in_file: str, out) -> None:
    """netSyntenic: annotate qDup, qOver/qFar, and fill types.

    Input '#' meta lines echo to the output (netSyntenic.c:281); the whole
    net is read before any write, so they land at the top."""
    meta_lines: list[str] = []
    nets = read_nets(in_file, meta_out=meta_lines.append)
    cov = _CoverageMap()

    def r_calc(fills):
        for fill in fills:
            if fill.chain_id:
                cov.add(fill.q_name, fill.q_start, fill.q_start + fill.q_size, 1)
            else:
                cov.add(fill.q_name, fill.q_start, fill.q_start + fill.q_size, -1)
            if fill.children:
                r_calc(fill.children)

    for net in nets:
        r_calc(net.fills)

    def r_syn(fills, parent):
        for fill in fills:
            if fill.chain_id:
                fs = fill.q_start
                fe = fs + fill.q_size
                fill.q_dup = cov.count_dup(fill.q_name, fs, fe)
                if parent is None:
                    fill.type = "top"
                elif fill.q_name != parent.q_name:
                    fill.type = "nonSyn"
                else:
                    ps = parent.q_start
                    pe = ps + parent.q_size
                    inter = min(fe, pe) - max(fs, ps)
                    if inter > 0:
                        fill.q_over = inter
                        fill.q_far = 0
                    else:
                        fill.q_over = 0
                        fill.q_far = -inter
                    fill.type = ("syn" if parent.q_strand == fill.q_strand
                                 else "inv")
            if fill.children:
                r_syn(fill.children, fill)

    for net in nets:
        r_syn(net.fills, None)

    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for line in meta_lines:
            f.write(line + "\n")
        write_nets(nets, f)
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# netFilter
# ---------------------------------------------------------------------------

class NetFilterOptions:
    def __init__(self, **kw):
        self.q = kw.get("q")
        self.not_q = kw.get("not_q")
        self.t = kw.get("t")
        self.not_t = kw.get("not_t")
        self.min_score = kw.get("min_score", -BIGNUM)
        self.max_score = kw.get("max_score", 9e99)
        self.min_gap = kw.get("min_gap", 0)
        self.min_ali = kw.get("min_ali", 0)
        self.max_ali = kw.get("max_ali", 0)
        self.min_size_t = kw.get("min_size_t", 0)
        self.min_size_q = kw.get("min_size_q", 0)
        self.q_start_min = kw.get("q_start_min", -BIGNUM)
        self.q_start_max = kw.get("q_start_max", BIGNUM)
        self.q_end_min = kw.get("q_end_min", -BIGNUM)
        self.q_end_max = kw.get("q_end_max", BIGNUM)
        self.t_start_min = kw.get("t_start_min", -BIGNUM)
        self.t_start_max = kw.get("t_start_max", BIGNUM)
        self.t_end_min = kw.get("t_end_min", -BIGNUM)
        self.t_end_max = kw.get("t_end_max", BIGNUM)
        self.q_overlap_start = kw.get("q_overlap_start", -BIGNUM)
        self.q_overlap_end = kw.get("q_overlap_end", BIGNUM)
        self.t_overlap_start = kw.get("t_overlap_start", -BIGNUM)
        self.t_overlap_end = kw.get("t_overlap_end", BIGNUM)
        self.syn = kw.get("syn", False)
        self.non_syn = kw.get("non_syn", False)
        self.chimp_syn = kw.get("chimp_syn", False)
        self.min_top_score = kw.get("min_top_score", 300000.0)
        self.min_syn_score = kw.get("min_syn_score", 200000.0)
        self.min_syn_size = kw.get("min_syn_size", 20000.0)
        self.min_syn_ali = kw.get("min_syn_ali", 10000.0)
        self.max_far = kw.get("max_far", 200000.0)
        self.fill_only = kw.get("fill_only", False)
        self.gap_only = kw.get("gap_only", False)
        self.types = kw.get("types")
        self.no_random = kw.get("no_random", False)
        self.no_hap = kw.get("no_hap", False)


def _syn_filter(fill: NetFill, o: NetFilterOptions) -> bool:
    if fill.type is None:
        raise ValueError("No type field, please run input net through netSyntenic")
    score = fill.score or 0
    ali = fill.ali or 0
    q_far = fill.q_far or 0
    if score >= o.min_syn_score and fill.t_size >= o.min_syn_size \
            and ali >= o.min_syn_ali:
        return True
    if fill.type == "top":
        return score >= o.min_top_score
    if fill.type == "nonSyn":
        return False
    if q_far > o.max_far:
        return False
    return True


def _chimp_syn_filter(fill: NetFill, o: NetFilterOptions) -> bool:
    if fill.type is None:
        raise ValueError("No type field, please run input net through netSyntenic")
    ali = fill.ali or 0
    q_far = fill.q_far or 0
    if ali >= 50:
        return True
    if ali < 15:
        return False
    if fill.type in ("top", "nonSyn"):
        return False
    if q_far > 1000:
        return False
    return True


def _filter_one(fill: NetFill, o: NetFilterOptions) -> bool:
    if o.q is not None and fill.q_name not in o.q:
        return False
    if o.not_q is not None and fill.q_name in o.not_q:
        return False
    if o.types is not None:
        if fill.type is None or fill.type not in o.types:
            return False
    if fill.chain_id:
        score = fill.score or 0
        ali = fill.ali or 0
        if o.gap_only:
            return False
        if fill.q_size < o.min_size_q:
            return False
        if fill.t_size < o.min_size_t:
            return False
        if score < o.min_score or score > o.max_score:
            return False
        if ali < o.min_ali:
            return False
        if ali > o.max_ali and o.max_ali != 0:
            return False
        if o.no_random:
            if (fill.q_name.endswith("_random")
                    or fill.q_name.startswith("chrUn")
                    or fill.q_name.lower() == "chrna"
                    or fill.q_name.lower() == "chru"):
                return False
        if o.no_hap and _is_haplotype(fill.q_name):
            return False
        if fill.q_start < o.q_start_min or fill.q_start >= o.q_start_max:
            return False
        q_end = fill.q_start + fill.q_size
        if q_end < o.q_end_min or q_end >= o.q_end_max:
            return False
        if fill.t_start < o.t_start_min or fill.t_start >= o.t_start_max:
            return False
        t_end = fill.t_start + fill.t_size
        if t_end < o.t_end_min or t_end >= o.t_end_max:
            return False
        if q_end < o.q_overlap_start or fill.q_start >= o.q_overlap_end:
            return False
        if t_end < o.t_overlap_start or fill.t_start >= o.t_overlap_end:
            return False
        if o.syn and not _syn_filter(fill, o):
            return False
        if o.non_syn and _syn_filter(fill, o):
            return False
        if o.chimp_syn and not _chimp_syn_filter(fill, o):
            return False
    else:
        if o.fill_only:
            return False
        if fill.t_size < o.min_gap:
            return False
    return True


def _cn_prune(fills: list[NetFill], o: NetFilterOptions) -> list[NetFill]:
    out = []
    for fill in fills:
        if _filter_one(fill, o):
            out.append(fill)
            if fill.children:
                fill.children = _cn_prune(fill.children, o)
    return out


def net_filter(in_files: list[str], out, **kw) -> None:
    """netFilter (recursive mode)."""
    o = NetFilterOptions(**kw)
    for key in ("q", "not_q", "t", "not_t"):
        v = getattr(o, key)
        if isinstance(v, str):
            setattr(o, key, set(v.split(",")))
    if isinstance(o.types, str):
        o.types = set(o.types.split(","))
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for path in in_files:
            for net in read_nets(path):
                if o.t is not None and net.name not in o.t:
                    continue
                if o.not_t is not None and net.name in o.not_t:
                    continue
                if o.no_random and (net.name.endswith("_random")
                                    or net.name.startswith("chrUn")
                                    or net.name.lower() in ("chrna", "chru")):
                    continue
                if o.no_hap and _is_haplotype(net.name):
                    continue
                net.fills = _cn_prune(net.fills, o)
                if net.fills:
                    write_nets([net], f)
    finally:
        if close:
            f.close()


def net_filter_line(in_files: list[str], out, **kw) -> None:
    """netFilter -line (netLineFilter, netFilter.c:320-345): judge each
    fill/gap line on its own - no recursion, no subtree pruning; every
    other line (net headers, comments) passes through verbatim.  Matching
    lines are re-serialized via cnFillWrite semantics at their original
    indentation."""
    from ..formats.net import _format_fill, _parse_fill_line
    o = NetFilterOptions(**kw)
    for key in ("q", "not_q", "t", "not_t"):
        v = getattr(o, key)
        if isinstance(v, str):
            setattr(o, key, set(v.split(",")))
    if isinstance(o.types, str):
        o.types = set(o.types.split(","))
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for path in in_files:
            with open(path) as src:
                for raw in src:
                    line = raw.rstrip("\n")
                    d = len(line) - len(line.lstrip(" "))
                    body = line[d:]
                    if body.startswith("fill") or body.startswith("gap"):
                        fill = _parse_fill_line(body)
                        if _filter_one(fill, o):
                            f.write(" " * d + _format_fill(fill) + "\n")
                    else:
                        f.write(line + "\n")
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# netToBed / netSplit
# ---------------------------------------------------------------------------

def net_to_bed(in_file: str, out, max_gap: int | None = None,
               min_fill: int | None = None) -> None:
    """netToBed (simple mode unless max_gap/min_fill given)."""
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        if max_gap is None and min_fill is None:
            chrom = None
            with open(in_file) as src:
                for line in src:
                    w = line.split()
                    if not w:
                        continue
                    if w[0] == "net":
                        chrom = w[1]
                    else:
                        start, size = int(w[1]), int(w[2])
                        f.write(f"{chrom}\t{start}\t{start + size}\n")
            return
        max_gap = BIGNUM if max_gap is None else max_gap
        min_fill = 0 if min_fill is None else min_fill

        def r_net_to_bed(net: Net, fills):
            for fill in fills:
                if fill.t_size >= min_fill:
                    start = fill.t_start
                    for gap in fill.children:
                        if gap.t_size >= max_gap:
                            f.write(f"{net.name}\t{start}\t{gap.t_start}"
                                    f"\t{fill.q_name}\n")
                            start = gap.t_start + gap.t_size
                        r_net_to_bed(net, gap.children)
                    f.write(f"{net.name}\t{start}\t{fill.t_end}"
                            f"\t{fill.q_name}\n")

        for net in read_nets(in_file):
            r_net_to_bed(net, net.fills)
    finally:
        if close:
            f.close()


def net_split(in_net: str, out_dir: str) -> None:
    """netSplit: one net file per chromosome."""
    os.makedirs(out_dir, exist_ok=True)
    for net in read_nets(in_net):
        write_nets([net], os.path.join(out_dir, f"{net.name}.net"))


# ---------------------------------------------------------------------------
# netToAxt
# ---------------------------------------------------------------------------

def net_to_axt(net_file: str, chain_file: str, t_2bit: str, q_2bit: str, out,
               max_gap: int = 100, q_chain: bool = False,
               split_on_insert: bool = True,
               gap_out: str | None = None) -> None:
    """netToAxt: subset chains by net fills, split at child inserts.

    gap_out: two-column dt/dq gap sizes of every written (sub)chain
    (writeGaps, netToAxt.c:49-58), emitted before that chain's axts."""
    from ..formats.axt import write_axts
    from ..formats.net import mark_used_chain_ids

    net_meta: list[str] = []
    nets = read_nets(net_file, meta_out=net_meta.append)
    used = mark_used_chain_ids(nets)
    chains: dict[int, Chain] = {}
    for chain in iter_chains(chain_file):
        if chain.id in used:
            if chain.id in chains:
                raise ValueError(f"Duplicate chain {chain.id}")
            chains[chain.id] = chain.swapped() if q_chain else chain
    t_genome = _CharGenome(t_2bit)
    q_genome = _CharGenome(q_2bit)
    gap_file = open(gap_out, "w") if gap_out else None

    axts = []

    def write_chain_part(chain: Chain, t_start: int, t_end: int):
        sub = chain.subset_on_t(t_start, t_end)
        if sub is None:
            raise ValueError(f"null subchain in chain ID {chain.id}")
        if gap_file is not None:
            b = sub.blocks
            for j in range(1, b.shape[0]):
                gap_file.write(f"{b[j, 0] - b[j - 1, 1]}\t"
                               f"{b[j, 2] - b[j - 1, 3]}\n")
        t_chars = t_genome.chars(chain.t_name, "+")
        q_chars = q_genome.chars(chain.q_name, chain.q_strand)
        axts.extend(chain_to_axt_records(sub, q_chars, 0, t_chars, 0, max_gap))

    def convert_fill(fill: NetFill, chain: Chain):
        if split_on_insert:
            t_start = fill.t_start
            children = fill.children
            i = 0
            while True:
                j = None
                for k in range(i, len(children)):
                    if children[k].children:
                        j = k
                        break
                if j is None:
                    break
                child = children[j]
                write_chain_part(chain, t_start, child.t_start)
                t_start = child.t_start + child.t_size
                i = j + 1
            write_chain_part(chain, t_start, fill.t_end)
        else:
            write_chain_part(chain, fill.t_start, fill.t_end)

    def r_convert(fills):
        for fill in fills:
            if fill.chain_id:
                convert_fill(fill, chains[fill.chain_id])
            if fill.children:
                r_convert(fill.children)

    for net in nets:
        r_convert(net.fills)

    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for line in net_meta:
            f.write(line + "\n")
        write_axts(axts, f)
    finally:
        if gap_file is not None:
            gap_file.close()
        if close:
            f.close()
