"""Net format model and I/O (fill/gap indentation tree).

Behavioral reference: kent/src/hg/lib/chainNet.c (cnFillFromLine:86-150,
cnFillRead:152-185, chainNetRead:244-264, cnFillWrite/chainNetWrite:187-242)
and kent/src/hg/mouseStuff/netFormat.doc.

A net file is a forest: `net <chrom> <size>` headers, then fill/gap lines
whose depth is the number of leading spaces.  Each line is:
  (fill|gap) start size oName oStrand oStart oSize [tag value]...
Recognized tags: id score ali qOver qFar qDup type tN qN tR qR tNewR qNewR
tOldR qOldR tTrf qTrf.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field

# tag order used by cnFillWrite
_TAG_ORDER = [
    "id", "score", "ali", "qOver", "qFar", "qDup", "type",
    "tN", "qN", "tR", "qR", "tNewR", "qNewR", "tOldR", "qOldR",
    "tTrf", "qTrf",
]
_INT_TAGS = {t for t in _TAG_ORDER if t not in ("type", "score", "id")}


@dataclass
class NetFill:
    """A fill or gap node (chain_id == 0 means gap, as in cnFill)."""

    t_start: int
    t_size: int
    q_name: str
    q_strand: str
    q_start: int
    q_size: int
    chain_id: int = 0
    score: float | None = None
    ali: int | None = None
    q_over: int | None = None
    q_far: int | None = None
    q_dup: int | None = None
    type: str | None = None
    opt: dict = field(default_factory=dict)  # remaining int tags
    children: list["NetFill"] = field(default_factory=list)

    @property
    def t_end(self) -> int:
        return self.t_start + self.t_size

    @property
    def is_fill(self) -> bool:
        return self.chain_id != 0


@dataclass
class Net:
    name: str
    size: int
    fills: list[NetFill] = field(default_factory=list)  # top-level fills


def _parse_fill_line(rest: str) -> NetFill:
    w = rest.split()
    kind = w[0]
    f = NetFill(
        t_start=int(w[1]), t_size=int(w[2]),
        q_name=w[3], q_strand=w[4],
        q_start=int(w[5]), q_size=int(w[6]),
    )
    i = 7
    while i + 1 < len(w) + 1 and i < len(w):
        tag = w[i]
        if i + 1 >= len(w):
            break
        val = w[i + 1]
        i += 2
        if tag == "id":
            f.chain_id = int(val)
        elif tag == "score":
            f.score = float(val)
        elif tag == "ali":
            f.ali = int(val)
        elif tag == "qOver":
            f.q_over = int(val)
        elif tag == "qFar":
            f.q_far = int(val)
        elif tag == "qDup":
            f.q_dup = int(val)
        elif tag == "type":
            f.type = val
        else:
            f.opt[tag] = int(val)
    if kind == "gap":
        f.chain_id = 0
    return f


def read_nets(path_or_file, meta_out=None) -> list[Net]:
    """chainNetRead over the whole file.

    meta_out: optional callable receiving '#' metadata lines in encounter
    order (lineFileSetMetaDataOutput protocol, linefile.c:93-101)."""
    if isinstance(path_or_file, str):
        if path_or_file.endswith(".gz"):
            f = io.TextIOWrapper(gzip.open(path_or_file, "rb"))
        else:
            f = open(path_or_file)
        close = True
    else:
        f = path_or_file
        close = False
    try:
        nets: list[Net] = []
        # stack[d] = list to which children at depth d+1 get appended
        stack: list[list[NetFill]] = []
        node_stack: list[NetFill] = []
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                if meta_out is not None:
                    meta_out(line)
                continue
            if line.startswith("net "):
                w = line.split()
                nets.append(Net(name=w[1], size=int(w[2])))
                stack = [nets[-1].fills]
                node_stack = []
                continue
            depth = len(line) - len(line.lstrip(" "))
            if depth < 1 or not nets:
                raise ValueError(f"Expecting indented fill/gap line: {line!r}")
            node = _parse_fill_line(line.lstrip(" "))
            # attach at depth: parent is node at depth-1
            while len(node_stack) >= depth:
                node_stack.pop()
                stack.pop()
            stack[-1].append(node)
            node_stack.append(node)
            stack.append(node.children)
        return nets
    finally:
        if close:
            f.close()


def _format_fill(f: NetFill) -> str:
    kind = "fill" if f.is_fill else "gap"
    parts = [f"{kind} {f.t_start} {f.t_size} {f.q_name} {f.q_strand} "
             f"{f.q_start} {f.q_size}"]
    if f.chain_id:
        parts.append(f"id {f.chain_id}")
    # cnFillWrite prints score only when > 0 and ali only when > 0
    if f.score is not None and f.score > 0:
        parts.append(f"score {f.score:.0f}")
    if f.ali is not None and f.ali > 0:
        parts.append(f"ali {f.ali}")
    if f.q_over is not None:
        parts.append(f"qOver {f.q_over}")
    if f.q_far is not None:
        parts.append(f"qFar {f.q_far}")
    if f.q_dup is not None:
        parts.append(f"qDup {f.q_dup}")
    if f.type is not None:
        parts.append(f"type {f.type}")
    for tag in _TAG_ORDER:
        if tag in f.opt:
            parts.append(f"{tag} {f.opt[tag]}")
    return " ".join(parts)


def _write_fill(f, fill: NetFill, depth: int) -> None:
    f.write(" " * depth + _format_fill(fill) + "\n")
    for child in fill.children:
        _write_fill(f, child, depth + 1)


def write_nets(nets: list[Net], path_or_file) -> None:
    """chainNetWrite."""
    if isinstance(path_or_file, str):
        out = open(path_or_file, "w")
        close = True
    else:
        out = path_or_file
        close = False
    try:
        for net in nets:
            out.write(f"net {net.name} {net.size}\n")
            for fill in net.fills:
                _write_fill(out, fill, 1)
    finally:
        if close:
            out.close()


def mark_used_chain_ids(nets: list[Net]) -> set[int]:
    """chainNetMarkUsed: collect all chain ids referenced by fills."""
    used: set[int] = set()

    def rec(fill: NetFill):
        if fill.chain_id:
            used.add(fill.chain_id)
        for ch in fill.children:
            rec(ch)

    for net in nets:
        for fill in net.fills:
            rec(fill)
    return used
