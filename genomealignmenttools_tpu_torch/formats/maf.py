"""MAF format (multiple alignment format) reader/writer.

Behavioral reference: kent/src/lib/maf.c (mafNext, mafWriteDelimiter,
mafWriteStart).  The writer reproduces kent's field-width alignment
("%-*s" src, right-aligned numerics) and the `a score=%f` header.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class MafComp:
    src: str
    src_size: int
    strand: str
    start: int
    size: int
    text: str


@dataclass
class MafAli:
    score: float = 0.0
    components: list[MafComp] = field(default_factory=list)

    @property
    def text_size(self) -> int:
        return len(self.components[0].text) if self.components else 0


def read_mafs(path_or_file):
    """mafNext over the whole file; returns list of MafAli."""
    if isinstance(path_or_file, str):
        f = open(path_or_file)
        close = True
    else:
        f = path_or_file
        close = False
    try:
        out: list[MafAli] = []
        cur: MafAli | None = None
        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("#") or not line.strip():
                if cur is not None and not line.strip():
                    out.append(cur)
                    cur = None
                continue
            if line.startswith("a"):
                if cur is not None:
                    out.append(cur)
                cur = MafAli()
                for tok in line.split()[1:]:
                    if tok.startswith("score="):
                        cur.score = float(tok[6:])
            elif line.startswith("s ") and cur is not None:
                w = line.split()
                cur.components.append(MafComp(
                    src=w[1], start=int(w[2]), size=int(w[3]), strand=w[4],
                    src_size=int(w[5]), text=w[6]))
            # 'e', 'i', 'q', 'r' lines are skipped (annotation rows)
        if cur is not None:
            out.append(cur)
        return out
    finally:
        if close:
            f.close()


def _digits(x: int) -> int:
    return len(str(x))


def format_maf(ali: MafAli) -> str:
    """mafWriteDelimiter + the blank separator line."""
    lines = [f"a score={ali.score:f}"]
    src_w = start_w = size_w = srcsize_w = 0
    for c in ali.components:
        src = c.src if c.src != "." else "defaultName"
        src_w = max(src_w, len(src))
        start_w = max(start_w, _digits(c.start))
        size_w = max(size_w, _digits(c.size))
        srcsize_w = max(srcsize_w, _digits(c.src_size))
    for c in ali.components:
        src = c.src if c.src != "." else "defaultName"
        lines.append(
            f"s {src:<{src_w}} {c.start:>{start_w}} {c.size:>{size_w}} "
            f"{c.strand} {c.src_size:>{srcsize_w}} {c.text}")
    return "\n".join(lines) + "\n\n"


def write_mafs(alis, path_or_file, scoring: str | None = "blastz") -> None:
    if isinstance(path_or_file, str):
        out = open(path_or_file, "w")
        close = True
    else:
        out = path_or_file
        close = False
    try:
        header = "##maf version=1"
        if scoring is not None:
            header += f" scoring={scoring}"
        out.write(header + "\n")
        for ali in alis:
            out.write(format_maf(ali))
    finally:
        if close:
            out.close()
