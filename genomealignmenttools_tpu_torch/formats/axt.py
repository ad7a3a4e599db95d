"""axt format: blocked pairwise alignments with explicit sequence text.

Behavioral reference: kent/src/lib/axt.c (axtRead:~100, axtWrite,
axtAddBlocksToBoxInList:~1040).  An axt record is a header line
  index tName tStart+1 tEnd qName qStart+1 qEnd strand score
followed by the target and query alignment text (with '-' gaps) and a
blank line.  Coordinates in memory are half-open 0-based; for '-' strand
records the q coordinates are in reverse-complement space (like chains).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass

import numpy as np


@dataclass
class Axt:
    q_name: str
    q_start: int
    q_end: int
    q_strand: str
    t_name: str
    t_start: int
    t_end: int
    score: int
    q_sym: str
    t_sym: str

    @property
    def sym_count(self) -> int:
        return len(self.q_sym)


def iter_axts(path_or_file, meta_out=None):
    """Streaming axt reader.  meta_out: callable receiving '#' lines at
    encounter (lineFileSetMetaDataOutput protocol, linefile.c:93-101), or a
    list to append to."""
    if isinstance(path_or_file, str):
        if path_or_file.endswith(".gz"):
            f = io.TextIOWrapper(gzip.open(path_or_file, "rb"))
        else:
            f = open(path_or_file)
        close = True
    else:
        f = path_or_file
        close = False
    emit = (meta_out.append if isinstance(meta_out, list) else meta_out)
    try:
        lines = iter(f)
        for raw in lines:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                if emit is not None:
                    emit(line)
                continue
            w = line.split()
            if len(w) < 9:
                raise ValueError(f"Bad axt header: {line!r}")
            t_sym = next(lines).rstrip("\n")
            q_sym = next(lines).rstrip("\n")
            yield Axt(
                q_name=w[4], q_start=int(w[5]) - 1, q_end=int(w[6]),
                q_strand=w[7], t_name=w[1], t_start=int(w[2]) - 1,
                t_end=int(w[3]), score=int(w[8]),
                q_sym=q_sym, t_sym=t_sym)
    finally:
        if close:
            f.close()


def read_axts(path_or_file, meta_out: list[str] | None = None) -> list[Axt]:
    return list(iter_axts(path_or_file, meta_out=meta_out))


def write_axts(axts, path_or_file) -> None:
    if isinstance(path_or_file, str):
        out = open(path_or_file, "w")
        close = True
    else:
        out = path_or_file
        close = False
    try:
        for i, a in enumerate(axts):
            out.write(f"{i} {a.t_name} {a.t_start + 1} {a.t_end} {a.q_name} "
                      f"{a.q_start + 1} {a.q_end} {a.q_strand} {a.score}\n")
            out.write(a.t_sym + "\n")
            out.write(a.q_sym + "\n")
            out.write("\n")
    finally:
        if close:
            out.close()


_IS_ALPHA = np.zeros(256, bool)
for _c in range(256):
    _IS_ALPHA[_c] = chr(_c).isalpha()


def axt_to_blocks(axt: Axt) -> np.ndarray:
    """Gapless blocks of an axt as (n,4) [tS,tE,qS,qE] int64
    (axtAddBlocksToBoxInList semantics, but in forward order);
    vectorized over the alignment columns."""
    # fast path: no gap characters at all -> one block (the common case
    # for seed-extend outputs)
    qs_sym, ts_sym = axt.q_sym, axt.t_sym
    if ("-" not in qs_sym and "-" not in ts_sym
            and qs_sym.isalpha() and ts_sym.isalpha()):
        return np.array([[axt.t_start, axt.t_start + len(ts_sym),
                          axt.q_start, axt.q_start + len(qs_sym)]],
                        np.int64)
    q = np.frombuffer(axt.q_sym.encode("latin-1"), np.uint8)
    t = np.frombuffer(axt.t_sym.encode("latin-1"), np.uint8)
    adv_q = _IS_ALPHA[q]
    adv_t = _IS_ALPHA[t]
    both = adv_q & adv_t
    if not both.any():
        return np.zeros((0, 4), np.int64)
    # run starts/ends of `both`
    b = both.astype(np.int8)
    d = np.diff(b, prepend=0, append=0)
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    # positions advance by the prefix counts of adv_q / adv_t
    q_cum = np.concatenate([[0], np.cumsum(adv_q)])
    t_cum = np.concatenate([[0], np.cumsum(adv_t)])
    q_s = axt.q_start + q_cum[starts]
    q_e = axt.q_start + q_cum[ends]
    t_s = axt.t_start + t_cum[starts]
    t_e = axt.t_start + t_cum[ends]
    keep = q_e > q_s
    return np.stack([t_s[keep], t_e[keep], q_s[keep], q_e[keep]],
                    axis=1).astype(np.int64)
