"""PSL format (21-column pairwise alignment summaries).

Behavioral reference: kent/src/lib/psl.c (pslNext/pslWriteAll) and the
standard PSL spec.  Comment lines ('#') are preserved as pass-through
metadata like kent's lineFile does (linefile.c:66-110).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Psl:
    matches: int
    mis_matches: int
    rep_matches: int
    n_count: int
    q_num_insert: int
    q_base_insert: int
    t_num_insert: int
    t_base_insert: int
    strand: str
    q_name: str
    q_size: int
    q_start: int
    q_end: int
    t_name: str
    t_size: int
    t_start: int
    t_end: int
    block_count: int
    block_sizes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    q_starts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    t_starts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def to_line(self) -> str:
        def commalist(a):
            return "".join(f"{int(v)}," for v in a)
        return "\t".join(str(x) for x in [
            self.matches, self.mis_matches, self.rep_matches, self.n_count,
            self.q_num_insert, self.q_base_insert, self.t_num_insert,
            self.t_base_insert, self.strand, self.q_name, self.q_size,
            self.q_start, self.q_end, self.t_name, self.t_size, self.t_start,
            self.t_end, self.block_count, commalist(self.block_sizes),
            commalist(self.q_starts), commalist(self.t_starts)])


def _parse_int_list(s: str) -> np.ndarray:
    return np.array([int(x) for x in s.split(",") if x != ""], dtype=np.int64)


def parse_psl_line(line: str) -> Psl:
    w = line.rstrip("\n").split("\t")
    if len(w) < 21:
        w = line.split()
    return Psl(
        matches=int(w[0]), mis_matches=int(w[1]), rep_matches=int(w[2]),
        n_count=int(w[3]), q_num_insert=int(w[4]), q_base_insert=int(w[5]),
        t_num_insert=int(w[6]), t_base_insert=int(w[7]), strand=w[8],
        q_name=w[9], q_size=int(w[10]), q_start=int(w[11]), q_end=int(w[12]),
        t_name=w[13], t_size=int(w[14]), t_start=int(w[15]), t_end=int(w[16]),
        block_count=int(w[17]), block_sizes=_parse_int_list(w[18]),
        q_starts=_parse_int_list(w[19]), t_starts=_parse_int_list(w[20]))


def read_psls(path_or_file, meta_out: list[str] | None = None) -> list[Psl]:
    """Read PSL records; '#' lines are appended to meta_out if given."""
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
        out = []
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                if meta_out is not None:
                    meta_out.append(line)
                continue
            if line.startswith(("psLayout", "match", "-----", "    ")):
                continue  # psl header variants
            out.append(parse_psl_line(line))
        return out
    finally:
        if close:
            f.close()


def write_psls(psls, path_or_file) -> None:
    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as f:
            for p in psls:
                f.write(p.to_line() + "\n")
    else:
        for p in psls:
            path_or_file.write(p.to_line() + "\n")
