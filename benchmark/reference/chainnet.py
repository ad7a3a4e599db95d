"""chainNet's two nets, rebuilt from the chain file, and the check of a
program's nets against them.

The net is built as src/chainNet/chainNet.c builds it, in plain Python and
NumPy:

- chains are taken in file order (which must be score order) until the
  first below `minScore`; `-rescore` sets `minScore` to 0 (1022);
- each chromosome of each side keeps its free spaces, disjoint and in start
  order (an rbTree there, `Spaces` here).  A chain's target side
  (`addChainT`, 557-608) claims, in every space its range overlaps, the
  clipped extent of its blocks inside the space when that is at least
  `minFill` (`minSpace` / 2 unless given) long: the space goes, the parts
  left on either side stay where at least `minSpace` long (`fillSpace`,
  487-523), and every gap between two of its blocks that lies strictly
  inside the space and is at least `minSpace` long becomes a gap of the new
  fill and a space of its own.  The query side (`addChainQ`, 610-679) does
  the same on the plus strand of the query, with a minus-strand chain's
  blocks reversed; there a gap's target range runs from the next block's
  start to the block's end, both flanking blocks included, as the C tool
  writes it;
- `finishNet` (725-738) sorts each gap's fills and each fill's gaps by
  start and gives every fill its range on the other side from the blocks
  it covers, clipped (`tFillOtherRange` 441-484, `qFillOtherRange`);
- a fill's line (`subchainInfo` 795-843, `rOutputFill` / `fillOut` /
  `rOutputGap` 858-896) gives its aligned bases and a score: the chain's
  own where the fill covers the whole chain, otherwise the chain's score
  times the share of its aligned bases inside the fill, or, with
  `-rescore` on the target side, the exact score of `chainSubsetOnT` by
  `chainCalcScore`, at least 1 (`getChainScore` 230-248).  A fill whose
  score is below `minScore` or whose aligned bases are fewer than `minFill`
  is left out with all it holds.

Haplotype sequences (`-inclHap`) are not looked at: no name in the
benchmark's workloads has `_hap` or `_alt` in it.  The flags the check
holds the program to are the traffic mix's (`traffic/chainnet-rescore-
minspace1.json`, as FilterChains_Net_FilterNets.perl:95-96 runs chainNet):
MIN_SPACE and RESCORE below.
"""

from __future__ import annotations

import os
from bisect import bisect_left, bisect_right, insort

import numpy as np

from .common import scorer

MIN_SPACE = 1
RESCORE = True


class Gap:
    __slots__ = ("start", "end", "o_start", "o_end", "fills")

    def __init__(self, start, end, o_start=0, o_end=0):
        self.start, self.end = start, end
        self.o_start, self.o_end = o_start, o_end
        self.fills = []


class Fill:
    __slots__ = ("start", "end", "chain", "o_start", "o_end", "gaps")

    def __init__(self, start, end, chain):
        self.start, self.end, self.chain = start, end, chain
        self.o_start = self.o_end = 0
        self.gaps = []


class Spaces:
    """The free spaces of one chromosome: disjoint [start, end) ranges, each
    with the gap it lies in, in start order, kept in buckets of at most
    2 * LOAD so that an insertion moves a bucket and not the whole list."""

    LOAD = 256

    def __init__(self, size: int, root: Gap):
        self.buckets = [[(0, size, root)]]
        self.firsts = [0]

    def _bucket(self, start: int) -> int:
        return max(0, bisect_right(self.firsts, start) - 1)

    def overlapping(self, start: int, end: int) -> list:
        """The spaces that overlap [start, end), in start order."""
        out = []
        b = self._bucket(start)
        i = bisect_left(self.buckets[b], start, key=lambda s: s[0])
        if i > 0:
            i -= 1
        elif b > 0:
            b -= 1
            i = len(self.buckets[b]) - 1
        while b < len(self.buckets):
            bucket = self.buckets[b]
            while i < len(bucket):
                s = bucket[i]
                if s[0] >= end:
                    return out
                if s[1] > start:
                    out.append(s)
                i += 1
            b, i = b + 1, 0
        return out

    def add(self, start: int, end: int, gap: Gap) -> None:
        b = self._bucket(start)
        bucket = self.buckets[b]
        insort(bucket, (start, end, gap), key=lambda s: s[0])
        self.firsts[b] = bucket[0][0]
        if len(bucket) > 2 * self.LOAD:
            self.buckets[b:b + 1] = [bucket[:self.LOAD],
                                     bucket[self.LOAD:]]
            self.firsts[b:b + 1] = [bucket[0][0], bucket[self.LOAD][0]]

    def remove(self, space: tuple) -> None:
        b = self._bucket(space[0])
        bucket = self.buckets[b]
        i = bisect_left(bucket, space[0], key=lambda s: s[0])
        if i == len(bucket) or bucket[i] is not space:
            raise ValueError(f"no space at {space[0]}")
        del bucket[i]
        if bucket:
            self.firsts[b] = bucket[0][0]
        elif len(self.buckets) > 1:
            del self.buckets[b], self.firsts[b]


class Side:
    """One chromosome of one side of the net."""

    def __init__(self, name: str, size: int):
        self.name, self.size = name, size
        self.root = Gap(0, size)
        self.spaces = Spaces(size, self.root)


def _inner(starts, ends, lo: int, hi: int, min_fill: int):
    """The extent of the blocks inside [lo, hi), clipped to it, or None
    where there is none or it is shorter than min_fill (innerBounds)."""
    a = int(np.searchsorted(ends, lo, "right"))
    b = int(np.searchsorted(starts, hi, "left"))
    if a >= b:
        return None
    s, e = max(int(starts[a]), lo), min(int(ends[b - 1]), hi)
    return (s, e) if e - s >= min_fill else None


class Net:
    """Both sides of the net of a score-sorted chain list."""

    def __init__(self, chains: list, t_sizes: dict, q_sizes: dict,
                 min_space: int = 25, min_fill: int | None = None,
                 min_score: float = 2000):
        self.chains = chains
        self.min_space = min_space
        self.min_fill = min_space // 2 if min_fill is None else min_fill
        self.min_score = min_score
        self.t = {n: Side(n, s) for n, s in t_sizes.items()}
        self.q = {n: Side(n, s) for n, s in q_sizes.items()}
        last = None
        for k, c in enumerate(chains):
            if last is not None and c["score"] > last:
                raise ValueError("chains not in score order")
            last = c["score"]
            if c["score"] < min_score:
                break
            b = c["blocks"]
            self._add(self.t[c["t_name"]], k, b[:, 0], b[:, 1],
                      self._t_others(c))
            qb = self.q_plus(c)
            self._add(self.q[c["q_name"]], k, qb[:, 2], qb[:, 3],
                      self._q_others(c, qb))
        for side in (self.t, self.q):
            for chrom in side.values():
                self._finish(chrom.root, side is self.q)

    @staticmethod
    def q_plus(c: dict) -> np.ndarray:
        """The blocks with the query on its plus strand, in query order."""
        b = c["blocks"]
        if c["q_strand"] == "+":
            return b
        qs = c["q_size"]
        r = b[::-1]
        return np.stack([r[:, 0], r[:, 1], qs - r[:, 3], qs - r[:, 2]], 1)

    @staticmethod
    def _t_others(c: dict):
        """The query range of the gap after each block (target side)."""
        b = c["blocks"]
        lo, hi = b[:-1, 3], b[1:, 2]
        if c["q_strand"] == "-":
            lo, hi = c["q_size"] - hi, c["q_size"] - lo
        return lo, hi

    @staticmethod
    def _q_others(c: dict, qb: np.ndarray):
        """The target range of the gap after each block (query side): on
        the minus strand from the next block's start to this one's end."""
        if c["q_strand"] == "+":
            return qb[:-1, 1], qb[1:, 0]
        return qb[1:, 0], qb[:-1, 1]

    def _add(self, chrom: Side, k: int, starts, ends, others) -> None:
        spaces = chrom.spaces
        gs, ge = ends[:-1], starts[1:]
        ok = ge - gs >= self.min_space
        for space in spaces.overlapping(int(starts[0]), int(ends[-1])):
            lo, hi, gap = space
            se = _inner(starts, ends, lo, hi, self.min_fill)
            if se is None:
                continue
            s, e = se
            spaces.remove(space)
            if s - lo >= self.min_space:
                spaces.add(lo, s, gap)
            if hi - e >= self.min_space:
                spaces.add(e, hi, gap)
            fill = Fill(s, e, k)
            gap.fills.append(fill)
            for i in np.flatnonzero(ok & (gs > lo) & (ge < hi)).tolist():
                g = Gap(int(gs[i]), int(ge[i]), int(others[0][i]),
                        int(others[1][i]))
                spaces.add(g.start, g.end, g)
                fill.gaps.append(g)

    def _finish(self, gap: Gap, is_q: bool) -> None:
        gap.fills.sort(key=lambda f: f.start)
        for f in gap.fills:
            self._other_range(f, is_q)
            f.gaps.sort(key=lambda g: g.start)
            for g in f.gaps:
                self._finish(g, is_q)

    def _own(self, f: Fill, is_q: bool) -> tuple[int, int]:
        """The fill's range in its chain's coordinates: on a query side,
        a minus-strand chain's are the minus strand's."""
        c = self.chains[f.chain]
        if is_q and c["q_strand"] == "-":
            return c["q_size"] - f.end, c["q_size"] - f.start
        return f.start, f.end

    def _other_range(self, f: Fill, is_q: bool) -> None:
        """The fill's extent and its range on the other side, from the
        blocks inside it, clipped (tFillOtherRange, qFillOtherRange)."""
        c = self.chains[f.chain]
        b = c["blocks"]
        lo, hi = self._own(f, is_q)
        minus = c["q_strand"] == "-"
        me, other = (2, 0) if is_q else (0, 2)
        a = int(np.searchsorted(b[:, me + 1], lo, "right"))
        z = int(np.searchsorted(b[:, me], hi, "left")) - 1
        s, e = max(int(b[a, me]), lo), min(int(b[z, me + 1]), hi)
        os_ = int(b[a, other]) + s - int(b[a, me])
        oe = int(b[z, other + 1]) - (int(b[z, me + 1]) - e)
        if is_q:
            f.start, f.end = ((c["q_size"] - e, c["q_size"] - s) if minus
                              else (s, e))
            f.o_start, f.o_end = os_, oe
        else:
            f.start, f.end = s, e
            f.o_start, f.o_end = ((c["q_size"] - oe, c["q_size"] - os_)
                                  if minus else (os_, oe))

    def fills(self, is_q: bool):
        """Every fill of one side, in output order."""
        side = self.q if is_q else self.t
        stack = [f for ch in reversed(side.values())
                 for f in reversed(ch.root.fills)]
        while stack:
            f = stack.pop()
            yield f
            for g in reversed(f.gaps):
                stack.extend(reversed(g.fills))

    def partial(self, f: Fill) -> bool:
        """A target fill that does not cover its whole chain."""
        b = self.chains[f.chain]["blocks"]
        return not (f.start <= b[0, 0] and f.end >= b[-1, 1])

    def sub_size(self, f: Fill, is_q: bool) -> int:
        """The chain's aligned bases inside the fill."""
        b = self.chains[f.chain]["blocks"]
        lo, hi = self._own(f, is_q)
        col = 2 if is_q else 0
        inter = np.minimum(b[:, col + 1], hi) - np.maximum(b[:, col], lo)
        return int(np.maximum(inter, 0).sum())

    def text(self, is_q: bool, exact: dict | None = None) -> str:
        """One side's net; `exact` maps a partial target fill (by id) to
        its exact score, where -rescore scores them."""
        side = self.q if is_q else self.t
        out = []
        for ch in side.values():
            if ch.root.fills:
                out.append(f"net {ch.name} {ch.size}\n")
                for f in ch.root.fills:
                    self._fill_out(out, f, 1, is_q, exact)
        return "".join(out)

    def _fill_out(self, out, f, depth, is_q, exact) -> None:
        c = self.chains[f.chain]
        b = c["blocks"]
        full = int((b[:, 1] - b[:, 0]).sum())
        lo, hi = self._own(f, is_q)
        col = 2 if is_q else 0
        if lo <= b[0, col] and hi >= b[-1, col + 1]:
            size, score = full, c["score"]
        else:
            size = self.sub_size(f, is_q)
            if not is_q and exact is not None:
                score = exact[id(f)] if exact[id(f)] > 0 else 1.0
            else:
                score = c["score"] * size / full
        if score < self.min_score or size < self.min_fill:
            return
        o_name = c["t_name"] if is_q else c["q_name"]
        pad = " " * depth
        out.append(f"{pad}fill {f.start} {f.end - f.start} {o_name} "
                   f"{c['q_strand']} {f.o_start} {f.o_end - f.o_start} "
                   f"id {c['id']} score {score:.0f} ali {size}\n")
        for g in f.gaps:
            out.append(f"{pad} gap {g.start} {g.end - g.start} {o_name} "
                       f"{c['q_strand']} {g.o_start} {g.o_end - g.o_start}\n")
            for sub in g.fills:
                self._fill_out(out, sub, depth + 2, is_q, exact)


def subset_on_t(c: dict, start: int, end: int) -> dict:
    """chainSubsetOnT: the blocks inside [start, end), clipped, the query
    moved with the target."""
    b = c["blocks"]
    a = int(np.searchsorted(b[:, 1], start, "right"))
    z = int(np.searchsorted(b[:, 0], end, "left"))
    sub = b[a:z].copy()
    cut = np.maximum(start - sub[0, 0], 0)
    sub[0, 0] += cut
    sub[0, 2] += cut
    cut = np.maximum(sub[-1, 1] - end, 0)
    sub[-1, 1] -= cut
    sub[-1, 3] -= cut
    return {"blocks": sub, "q_strand": c["q_strand"],
            "t_name": c["t_name"], "q_name": c["q_name"]}


def nets(chains: list, t_sizes: dict, q_sizes: dict, min_space: int = 25,
         min_fill: int | None = None, min_score: float = 2000,
         rescore: bool = False, score_subsets=None,
         approximate: bool = False) -> tuple[str, str]:
    """(target net, query net) as chainNet writes them.  With `rescore`,
    minScore is 0 and every partial target fill is scored exactly by
    `score_subsets(list of chains) -> scores`, unless `approximate`, which
    keeps stock chainNet's share of the chain's score (the control)."""
    if rescore:
        min_score = 0
    net = Net(chains, t_sizes, q_sizes, min_space, min_fill, min_score)
    exact = None
    if rescore and not approximate:
        part = [f for f in net.fills(False) if net.partial(f)]
        scores = score_subsets([subset_on_t(chains[f.chain], f.start, f.end)
                                for f in part]) if part else []
        exact = {id(f): float(s) for f, s in zip(part, scores)}
    return net.text(False, exact), net.text(True)


def read_sizes(path: str) -> dict:
    """A chrom.sizes file, in its order."""
    out = {}
    with open(path) as f:
        for ln in f:
            w = ln.split()
            if w:
                out[w[0]] = int(w[1])
    return out


def _sizes(workload: dict) -> tuple[dict, dict]:
    p = workload["paths"]
    return read_sizes(p["t_sizes"]), read_sizes(p["q_sizes"])


def expected(workload: dict, config: dict) -> tuple[str, str]:
    """The nets the program must write for the workload, kept in it: a run
    judges its outputs, the control and the faults against the same
    nets."""
    if "chainnet_nets" not in workload:
        t, q = _sizes(workload)
        workload["chainnet_nets"] = nets(
            workload["chains"], t, q, MIN_SPACE, rescore=RESCORE,
            score_subsets=scorer(workload, config).scores)
    return workload["chainnet_nets"]


def _keyed(lines: list[str]):
    """(key, score) a line: a fill line's key is the line without its
    score; any other line is its own key, with no score."""
    out = []
    for ln in lines:
        i = ln.find(" score ")
        if i > 0 and ln.lstrip().startswith("fill "):
            j = ln.find(" ", i + 7)
            try:
                out.append((ln[:i] + ln[j:], float(ln[i + 7:j])))
                continue
            except ValueError:
                pass
        out.append((ln, None))
    return out


def compare(got: list[str], want: list[str]) -> tuple[int, float]:
    """(lines wrong, largest score difference): lines of `want` missing
    from `got`, lines of `got` not in `want` and lines of both out of
    their place (all the common lines less the longest run that keeps
    `want`'s order), scores set aside; the score difference over the fill
    lines of both."""
    want_k = _keyed(want)
    where: dict = {}
    for i, (k, _) in enumerate(want_k):
        where.setdefault(k, []).append(i)
    for v in where.values():
        v.reverse()
    order = []
    gap = 0.0
    for k, s in _keyed(got):
        at = where.get(k)
        if not at:
            continue
        i = at.pop()
        order.append(i)
        if s is not None and want_k[i][1] is not None:
            gap = max(gap, abs(s - want_k[i][1]))
    tails: list[int] = []          # the longest increasing run, by patience
    for i in order:
        p = bisect_left(tails, i)
        if p == len(tails):
            tails.append(i)
        else:
            tails[p] = i
    common = len(order)
    wrong = (len(want) - common) + (len(got) - common) + (common - len(tails))
    return wrong, gap


def _lines(path: str) -> list[str]:
    with open(path) as f:
        return f.read().splitlines()


def check(workload: dict, config: dict, outputs: list[str]) -> list:
    """Both nets of the program (target, query) against the rebuilt ones:
    `lines_wrong` over both, `score_gap_max` over every fill of both."""
    wrong, gap = 0, 0.0
    for path, want in zip(outputs, expected(workload, config)):
        w, g = compare(_lines(path), want.splitlines())
        wrong += w
        gap = max(gap, g)
    return [("lines_wrong", wrong), ("score_gap_max", gap)]


def _write(out_dir: str, stem: str, texts) -> list[str]:
    paths = [os.path.join(out_dir, f"{stem}.t.net"),
             os.path.join(out_dir, f"{stem}.q.net")]
    for p, text in zip(paths, texts):
        with open(p, "w") as f:
            f.write(text)
    return paths


def control(workload: dict, config: dict, out_dir: str, dtype) -> list[str]:
    """Stock chainNet's nets: every partial target fill scored as its
    chain's score times the share of its aligned bases, which -rescore
    exists to replace.  `dtype` is not used: every subset score of the
    workload is an integer below 2**24, which float32 holds exactly."""
    t, q = _sizes(workload)
    return _write(out_dir, "control", nets(
        workload["chains"], t, q, MIN_SPACE, rescore=RESCORE,
        approximate=True))


def alter(lines: list[str]) -> list[str]:
    """The lines with the first fill's score one more."""
    out = list(lines)
    for i, ln in enumerate(out):
        if ln.lstrip().startswith("fill "):
            k = ln.index(" score ") + 7
            j = ln.index(" ", k)
            out[i] = ln[:k] + str(int(ln[k:j]) + 1) + ln[j:]
            break
    return out


def faults(workload: dict, work: str, outputs: list[str]) -> dict:
    """The program's nets with one error planted: `altered`, the first
    target fill's score one more."""
    lines = alter(_lines(outputs[0]))
    with open(os.path.join(work, "altered.t.net"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"altered": [os.path.join(work, "altered.t.net"), outputs[1]]}
