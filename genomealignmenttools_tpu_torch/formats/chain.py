"""Chain format model and byte-exact I/O.

Behavioral reference: kent/src/lib/chain.c (chainRead:337-346,
chainReadChainLine:256-296, chainReadBlocks:298-335, chainWrite:211-227,
chainSubsetOnT:471-558, chainSubsetOnQ:560-628, chainSwap:348-390) and
kent/src/hg/mouseStuff/chainFormat.doc.

Chains are stored structure-of-arrays: blocks are a (n,4) int64 array of
columns [tStart, tEnd, qStart, qEnd] - the natural layout both for numpy
host math and for shipping to the device.

Header line:
  chain score tName tSize tStrand tStart tEnd qName qSize qStrand qStart qEnd id
Block lines: size [dt dq]; the last block line has only size, followed by a
blank line.  The score is written with C printf %1.0f semantics.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass, field, replace

import numpy as np

BIGNUM = 0x3FFFFFFF


def format_score(score: float) -> str:
    """C printf %1.0f of a double: round-half-even, no decimals.

    Python's format() implements the same correctly-rounded decimal
    conversion as glibc printf, so this is exact.
    """
    return f"{score:.0f}"


@dataclass
class Chain:
    """One pairwise chain (t always + strand; q may be -)."""

    score: float
    t_name: str
    t_size: int
    t_start: int
    t_end: int
    q_name: str
    q_size: int
    q_strand: str
    q_start: int
    q_end: int
    id: int
    # blocks[:,0]=tStart blocks[:,1]=tEnd blocks[:,2]=qStart blocks[:,3]=qEnd
    blocks: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.int64))

    # -- convenience views ---------------------------------------------------
    @property
    def t_starts(self) -> np.ndarray:
        return self.blocks[:, 0]

    @property
    def t_ends(self) -> np.ndarray:
        return self.blocks[:, 1]

    @property
    def q_starts(self) -> np.ndarray:
        return self.blocks[:, 2]

    @property
    def q_ends(self) -> np.ndarray:
        return self.blocks[:, 3]

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[0]

    def block_sizes(self) -> np.ndarray:
        return self.blocks[:, 1] - self.blocks[:, 0]

    def ali_bases(self) -> int:
        """Total bases in gap-free alignments (chainBaseCount)."""
        return int((self.blocks[:, 1] - self.blocks[:, 0]).sum())

    def gap_dt_dq(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-gap (dt, dq) between consecutive blocks."""
        dt = self.blocks[1:, 0] - self.blocks[:-1, 1]
        dq = self.blocks[1:, 2] - self.blocks[:-1, 3]
        return dt, dq

    # -- format --------------------------------------------------------------
    def header_line(self) -> str:
        return (
            f"chain {format_score(self.score)} {self.t_name} {self.t_size} + "
            f"{self.t_start} {self.t_end} {self.q_name} {self.q_size} "
            f"{self.q_strand} {self.q_start} {self.q_end} {self.id}"
        )

    def to_text(self) -> str:
        """chainWrite: header, block lines, trailing blank line."""
        out = [self.header_line()]
        b = self.blocks
        n = b.shape[0]
        sizes = b[:, 1] - b[:, 0]
        if n > 1:
            dts = b[1:, 0] - b[:-1, 1]
            dqs = b[1:, 2] - b[:-1, 3]
            for i in range(n - 1):
                out.append(f"{sizes[i]}\t{dts[i]}\t{dqs[i]}")
        if n > 0:
            out.append(f"{sizes[n - 1]}")
        out.append("")
        return "\n".join(out) + "\n"

    # -- geometry ------------------------------------------------------------
    def calc_bounds(self) -> None:
        """chainCalcBounds: set t/q bounds from blocks."""
        if self.n_blocks == 0:
            return
        self.t_start = int(self.blocks[0, 0])
        self.q_start = int(self.blocks[0, 2])
        self.t_end = int(self.blocks[-1, 1])
        self.q_end = int(self.blocks[-1, 3])

    def subset_on_t(self, sub_start: int, sub_end: int) -> "Chain | None":
        """chainSubsetOnT / chainFastSubsetOnT.

        Returns self if [sub_start, sub_end) covers the whole chain, a new
        clipped chain otherwise, or None if no blocks overlap.  The new score
        is the reference's "fake" tSpan-ratio score (chain.c:552-555).
        """
        if sub_start <= self.t_start and sub_end >= self.t_end:
            return self
        b = self.blocks
        # blocks are strictly increasing in t, so the kept set
        # (tEnd > sub_start and tStart < sub_end) is one contiguous range
        lo = int(np.searchsorted(b[:, 1], sub_start, side="right"))
        hi = int(np.searchsorted(b[:, 0], sub_end, side="left"))
        if lo >= hi:
            return None
        nb = b[lo:hi].copy()
        # clip first/last blocks
        lo_clip = sub_start - nb[:, 0]
        lo_clip = np.maximum(lo_clip, 0)
        nb[:, 0] += lo_clip
        nb[:, 2] += lo_clip
        hi_clip = nb[:, 1] - sub_end
        hi_clip = np.maximum(hi_clip, 0)
        nb[:, 1] -= hi_clip
        nb[:, 3] -= hi_clip
        size_ratio = float(nb[-1, 1] - nb[0, 0]) / float(self.t_end - self.t_start)
        sub = Chain(
            score=size_ratio * self.score,
            t_name=self.t_name, t_size=self.t_size,
            t_start=int(nb[0, 0]), t_end=int(nb[-1, 1]),
            q_name=self.q_name, q_size=self.q_size, q_strand=self.q_strand,
            q_start=int(nb[:, 2].min()), q_end=int(nb[:, 3].max()),
            id=self.id, blocks=nb,
        )
        return sub

    def subset_on_q(self, sub_start: int, sub_end: int) -> "Chain | None":
        """chainSubsetOnQ (no fake score: score left as-is per reference)."""
        if sub_start <= self.q_start and sub_end >= self.q_end:
            return self
        b = self.blocks
        keep = (b[:, 3] > sub_start) & (b[:, 2] < sub_end)
        if not keep.any():
            return None
        nb = b[keep].copy()
        lo_clip = np.maximum(sub_start - nb[:, 2], 0)
        nb[:, 2] += lo_clip
        nb[:, 0] += lo_clip
        hi_clip = np.maximum(nb[:, 3] - sub_end, 0)
        nb[:, 3] -= hi_clip
        nb[:, 1] -= hi_clip
        sub = Chain(
            score=0.0,
            t_name=self.t_name, t_size=self.t_size,
            t_start=int(nb[:, 0].min()), t_end=int(nb[:, 1].max()),
            q_name=self.q_name, q_size=self.q_size, q_strand=self.q_strand,
            q_start=int(nb[0, 2]), q_end=int(nb[-1, 3]),
            id=self.id, blocks=nb,
        )
        return sub

    def swapped(self) -> "Chain":
        """chainSwap: swap target and query sides (returns a new Chain)."""
        nb = self.blocks[:, [2, 3, 0, 1]].copy()
        c = Chain(
            score=self.score,
            t_name=self.q_name, t_size=self.q_size,
            t_start=self.q_start, t_end=self.q_end,
            q_name=self.t_name, q_size=self.t_size, q_strand=self.q_strand,
            q_start=self.t_start, q_end=self.t_end,
            id=self.id, blocks=nb,
        )
        if c.q_strand == "-":
            # reverse ranges on both sides and flip block order
            ts, te = c.blocks[:, 0].copy(), c.blocks[:, 1].copy()
            qs, qe = c.blocks[:, 2].copy(), c.blocks[:, 3].copy()
            c.blocks[:, 0] = c.t_size - te
            c.blocks[:, 1] = c.t_size - ts
            c.blocks[:, 2] = c.q_size - qe
            c.blocks[:, 3] = c.q_size - qs
            c.blocks = c.blocks[::-1].copy()
            c.t_start, c.t_end = c.t_size - c.t_end, c.t_size - c.t_start
            c.q_start, c.q_end = c.q_size - c.q_end, c.q_size - c.q_start
        return c

    def remove_blocks_in_t_range(self, t_start: int, t_end: int) -> None:
        """chainRemoveBlocks (chainCleaner.c:649-686): drop every block whose
        tStart is in [t_start, t_end).  First/last blocks must survive."""
        b = self.blocks
        drop = (b[:, 0] >= t_start) & (b[:, 0] < t_end)
        if drop[0]:
            raise ValueError(
                f"chainRemoveBlocks would remove first block of chain {self.id}")
        if drop[-1]:
            raise ValueError(
                f"chainRemoveBlocks would remove last block of chain {self.id}")
        self.blocks = b[~drop]

    def clone(self) -> "Chain":
        return replace(self, blocks=self.blocks.copy())


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def parse_chain_header(line: str) -> Chain:
    row = line.split()
    if len(row) < 12 or row[0] != "chain":
        raise ValueError(f"Expecting chain line, got: {line!r}")
    c = Chain(
        score=float(row[1]),
        t_name=row[2], t_size=int(row[3]),
        t_start=int(row[5]), t_end=int(row[6]),
        q_name=row[7], q_size=int(row[8]), q_strand=row[9],
        q_start=int(row[10]), q_end=int(row[11]),
        id=int(row[12]) if len(row) >= 13 else 0,
    )
    if c.q_start >= c.q_end or c.t_start >= c.t_end:
        raise ValueError(f"End before start in chain line: {line!r}")
    if c.q_start < 0 or c.t_start < 0:
        raise ValueError(f"Start before zero in chain line: {line!r}")
    if c.q_end > c.q_size or c.t_end > c.t_size:
        raise ValueError(f"Past end of sequence in chain line: {line!r}")
    return c


def _blocks_from_triples(c: Chain, sizes, dts, dqs) -> np.ndarray:
    """Build the (n,4) block array from size/dt/dq runs (delta decoding)."""
    n = len(sizes)
    sizes = np.asarray(sizes, dtype=np.int64)
    dts = np.asarray(dts, dtype=np.int64)
    dqs = np.asarray(dqs, dtype=np.int64)
    t_starts = np.empty(n, np.int64)
    q_starts = np.empty(n, np.int64)
    t_starts[0] = c.t_start
    q_starts[0] = c.q_start
    if n > 1:
        steps_t = sizes[:-1] + dts
        steps_q = sizes[:-1] + dqs
        t_starts[1:] = c.t_start + np.cumsum(steps_t)
        q_starts[1:] = c.q_start + np.cumsum(steps_q)
    blocks = np.empty((n, 4), np.int64)
    blocks[:, 0] = t_starts
    blocks[:, 1] = t_starts + sizes
    blocks[:, 2] = q_starts
    blocks[:, 3] = q_starts + sizes
    if blocks[-1, 1] != c.t_end:
        raise ValueError(f"t end mismatch {blocks[-1, 1]} vs {c.t_end} in chain {c.id}")
    if blocks[-1, 3] != c.q_end:
        raise ValueError(f"q end mismatch {blocks[-1, 3]} vs {c.q_end} in chain {c.id}")
    return blocks


def read_chains(path_or_file, meta_out=None) -> list[Chain]:
    """Read all chains from a chain file (optionally .gz).

    Uses the native C++ codec (native/chaincodec.cpp) when available;
    results are identical to the python path.

    meta_out: optional callable receiving each '#' metadata line (sans
    newline) in encounter order - the lineFileSetMetaDataOutput protocol
    (reference kent/src/lib/linefile.c:93-101, 66-84)."""
    if isinstance(path_or_file, str):
        from ..native import chain_io
        try:
            if path_or_file.endswith(".gz"):
                import gzip as _gz
                with _gz.open(path_or_file, "rb") as fh:
                    data = fh.read()
            else:
                with open(path_or_file, "rb") as fh:
                    data = fh.read()
            native = chain_io.parse_chain_text(data)
            if native is not None:
                if meta_out is not None:
                    for bline in data.split(b"\n"):
                        if bline.startswith(b"#"):
                            meta_out(bline.decode())
                return native
        except OSError:
            pass
        f = _open_maybe_gz(path_or_file)
        close = True
    else:
        f = path_or_file
        close = False
    try:
        return _read_chains_stream(f, meta_out=meta_out)
    finally:
        if close:
            f.close()


def _read_chains_stream(f, meta_out=None) -> list[Chain]:
    chains: list[Chain] = []
    cur: Chain | None = None
    sizes: list[int] = []
    dts: list[int] = []
    dqs: list[int] = []
    next_id = 1

    def finish():
        nonlocal cur
        if cur is not None:
            cur.blocks = _blocks_from_triples(cur, sizes, dts, dqs)
            chains.append(cur)
            cur = None

    for raw in f:
        line = raw.rstrip("\n")
        if not line.strip():
            continue
        if line.startswith("#"):
            if meta_out is not None:
                meta_out(line)
            continue
        if line.startswith("chain"):
            finish()
            cur = parse_chain_header(line)
            if cur.id == 0:
                cur.id = next_id
                next_id += 1
            sizes, dts, dqs = [], [], []
        else:
            w = line.split()
            sizes.append(int(w[0]))
            if len(w) >= 3:
                dts.append(int(w[1]))
                dqs.append(int(w[2]))
    finish()
    return chains


def iter_chains(path_or_file, meta_out=None):
    """Generator over chains (streaming).

    meta_out: optional callable receiving '#' metadata lines at the moment
    they are crossed - matches lineFileNext's metaDataAdd interleaving
    (reference linefile.c:520-521), so a tool that streams chains to its
    output reproduces the reference's meta-line placement exactly."""
    if isinstance(path_or_file, str):
        f = _open_maybe_gz(path_or_file)
        close = True
    else:
        f = path_or_file
        close = False
    try:
        cur = None
        sizes, dts, dqs = [], [], []
        next_id = 1
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                if meta_out is not None:
                    meta_out(line)
                continue
            if line.startswith("chain"):
                if cur is not None:
                    cur.blocks = _blocks_from_triples(cur, sizes, dts, dqs)
                    yield cur
                cur = parse_chain_header(line)
                if cur.id == 0:
                    cur.id = next_id
                    next_id += 1
                sizes, dts, dqs = [], [], []
            else:
                w = line.split()
                sizes.append(int(w[0]))
                if len(w) >= 3:
                    dts.append(int(w[1]))
                    dqs.append(int(w[2]))
                elif cur is not None:
                    # 1-field line = final block: chainReadBlocks returns
                    # here (reference chain.c:298-335), so the chain is
                    # complete NOW - before any following '#' meta line is
                    # crossed.  Yield immediately to match that ordering.
                    cur.blocks = _blocks_from_triples(cur, sizes, dts, dqs)
                    yield cur
                    cur = None
        if cur is not None:
            cur.blocks = _blocks_from_triples(cur, sizes, dts, dqs)
            yield cur
    finally:
        if close:
            f.close()


def write_chains(chains, path_or_file) -> None:
    if isinstance(path_or_file, str):
        from ..native import chain_io
        chains = list(chains)
        blob = chain_io.serialize_chains(chains)
        if blob is not None:
            with open(path_or_file, "wb") as f:
                f.write(blob)
            return
        with open(path_or_file, "w") as f:
            for c in chains:
                f.write(c.to_text())
    else:
        # file object: still use the native serializer for the whole list
        from ..native import chain_io
        chains = list(chains)
        blob = chain_io.serialize_chains(chains)
        if blob is not None:
            path_or_file.write(bytes(blob).decode())
            return
        for c in chains:
            path_or_file.write(c.to_text())


# ---------------------------------------------------------------------------
# Sorting (chainSort semantics)
# ---------------------------------------------------------------------------

def sort_chains_by_score(chains: list[Chain]) -> list[Chain]:
    """chainSort default: score descending.  kent reads chains with
    slAddHead (reversing file order, chainSort.c:62-66) and slSort is a
    stable merge sort - so ties emit in REVERSE input order."""
    return sorted(reversed(chains), key=lambda c: -c.score)


def sort_chains_by_target(chains: list[Chain]) -> list[Chain]:
    """chainCmpTarget: (tName, tStart) ascending; ties in reverse input
    order (slAddHead + stable slSort, see sort_chains_by_score)."""
    return sorted(reversed(chains), key=lambda c: (c.t_name, c.t_start))


def sort_chains_by_query(chains: list[Chain]) -> list[Chain]:
    """chainCmpQuery: (qName, qStart) ascending; ties in reverse input
    order (slAddHead + stable slSort, see sort_chains_by_score)."""
    return sorted(reversed(chains), key=lambda c: (c.q_name, c.q_start))
