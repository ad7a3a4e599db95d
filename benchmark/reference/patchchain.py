"""patchChain's psl on the planted workload, judged by what it says.

It reads the psl and both 2bit files (their soft-mask blocks too) itself,
and the plan the generator made: each harvested gap window, the unmasked
homologous pieces and the masked ones.  The port writes each gap-free
block of a gapped alignment as a psl record of its own (one axt an HSP
row), so a record's alignment is the best chain of records of its gap
that holds it.  Numbers:
- psl_malformed: records whose fields disagree with each other (block
  counts, starts and ends, the counts' sum, the insert counts, sizes);
- outside_gap: records outside every harvested window (the gap, on both
  sides; the query on the - strand flipped);
- counts_wrong: records whose match, mismatch, repeat-match and N counts
  differ from a recount of their blocks, case counted as axtToPsl counts
  it (a lowercase base in a matching pair makes a repeat match);
- below_gapped_threshold: records whose alignment scores under L with
  the configuration's matrix and lastz's affine gap costs (O for a gap's
  first base, E for each further one): the best chain through the record
  of its gap's records, each next record after the last on both sides and
  at most MAX_GAP bases past it on each;
- masked_homologs_hit: aligned pairs on a wholly masked planted piece
  (its bases with their planted partners) in an alignment seeded from
  nowhere: the records of a gap joined by links (each next record after
  the last on both sides and at most MAX_GAP bases past it on each) make
  an alignment, and it is seeded when one of its records scores at least
  K on its own and holds W pairs in a row that match in unmasked letters
  on both sides, as a lastz HSP holds the seed word it grew from.  An
  unmasked piece's gapped extension may run on into a masked one, as
  lastz's does within its y-drop;
- homolog_missed_pct: the planted unmasked pairs (each unmasked piece's
  bases with their planted partners) that no record aligns, % of all;
- pairs_off_homolog: aligned pairs on no planted diagonal of their gap (a
  pair outside every gap counts too).
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAX_GAP = 200      # bases between two records of one alignment, a side
_LETTERS = np.frombuffer(b"TCAG", np.uint8)
_COMPLEMENT = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")
_KEY = np.int64(1) << 32


def read_twobit_chars(path: str) -> dict:
    """{name: uint8 array of the sequence's letters}: TCAG by code, N in
    N blocks, lowercase in mask blocks (twoBitReadSeqFrag's doMask)."""
    with open(path, "rb") as f:
        d = f.read()
    sig, _, n, _ = struct.unpack_from("<IIII", d, 0)
    if sig != 0x1A412743:
        raise ValueError(f"{path}: not a 2bit file")
    off, index = 16, []
    for _ in range(n):
        k = d[off]
        index.append((d[off + 1:off + 1 + k].decode(),
                      struct.unpack_from("<I", d, off + 1 + k)[0]))
        off += 5 + k
    out = {}
    for name, o in index:
        size, nb = struct.unpack_from("<II", d, o)
        n_starts = np.frombuffer(d, "<u4", nb, o + 8)
        n_sizes = np.frombuffer(d, "<u4", nb, o + 8 + 4 * nb)
        o += 8 + 8 * nb
        mb = struct.unpack_from("<I", d, o)[0]
        m_starts = np.frombuffer(d, "<u4", mb, o + 4)
        m_sizes = np.frombuffer(d, "<u4", mb, o + 4 + 4 * mb)
        o += 4 + 8 * mb + 4
        packed = np.frombuffer(d, np.uint8, (size + 3) // 4, o)
        codes = (np.stack([packed >> 6, packed >> 4, packed >> 2, packed],
                          1).reshape(-1)[:size] & 3)
        chars = _LETTERS[codes].copy()
        for s, z in zip(n_starts, n_sizes):
            chars[s:s + z] = ord("N")
        for s, z in zip(m_starts, m_sizes):
            chars[s:s + z] |= 0x20        # lowercase
        out[name] = chars
    return out


def read_psl(path: str) -> list:
    """The records of a psl file as lists of 21 fields (strings)."""
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f if ln.strip()]


def _ints(s: str) -> np.ndarray:
    return np.array([int(x) for x in s.split(",") if x != ""], np.int64)


class Record:
    __slots__ = ("counts", "strand", "q_name", "q_size", "q_start", "q_end",
                 "t_name", "t_size", "t_start", "t_end", "sizes", "q_starts",
                 "t_starts", "inserts")

    def __init__(self, w: list):
        (self.counts, self.inserts) = ([int(x) for x in w[0:4]],
                                       [int(x) for x in w[4:8]])
        self.strand, self.q_name, self.t_name = w[8], w[9], w[13]
        self.q_size, self.q_start, self.q_end = int(w[10]), int(w[11]), \
            int(w[12])
        self.t_size, self.t_start, self.t_end = int(w[14]), int(w[15]), \
            int(w[16])
        n = int(w[17])
        self.sizes, self.q_starts, self.t_starts = (_ints(w[18]),
                                                    _ints(w[19]),
                                                    _ints(w[20]))
        if not n == len(self.sizes) == len(self.q_starts) == \
                len(self.t_starts):
            raise ValueError("block count")

    def well_formed(self, seqs_t: dict, seqs_q: dict) -> bool:
        s, qs, ts = self.sizes, self.q_starts, self.t_starts
        if self.strand not in ("+", "-") or not len(s) or (s <= 0).any():
            return False
        if self.t_name not in seqs_t or self.q_name not in seqs_q \
                or len(seqs_t[self.t_name]) != self.t_size \
                or len(seqs_q[self.q_name]) != self.q_size:
            return False
        q_gaps = qs[1:] - (qs[:-1] + s[:-1])
        t_gaps = ts[1:] - (ts[:-1] + s[:-1])
        if (q_gaps < 0).any() or (t_gaps < 0).any():
            return False
        q0, q1 = qs[0], qs[-1] + s[-1]
        if self.strand == "-":
            q0, q1 = self.q_size - q1, self.q_size - q0
        return (self.t_start == ts[0] and self.t_end == ts[-1] + s[-1]
                and self.q_start == q0 and self.q_end == q1
                and 0 <= self.t_start and self.t_end <= self.t_size
                and 0 <= self.q_start and self.q_end <= self.q_size
                and sum(self.counts) == int(s.sum())
                and self.inserts == [int((q_gaps > 0).sum()),
                                     int(q_gaps.sum()),
                                     int((t_gaps > 0).sum()),
                                     int(t_gaps.sum())])

    def pairs(self):
        """(t, q) of every aligned pair, the query on the record's strand."""
        ar = np.arange(int(self.sizes.sum()), dtype=np.int64)
        first = np.cumsum(self.sizes) - self.sizes
        return (np.repeat(self.t_starts - first, self.sizes) + ar,
                np.repeat(self.q_starts - first, self.sizes) + ar)


def _on_strand(chars: np.ndarray, strand: str) -> np.ndarray:
    """A sequence's letters on the given strand (- reverse-complemented)."""
    if strand == "+":
        return chars
    return np.frombuffer(chars.tobytes().translate(_COMPLEMENT)[::-1],
                         np.uint8)


def _recount(rec: Record, t_chars: np.ndarray, q_chars: np.ndarray) -> list:
    """axtToPsl's match, mismatch, repeat-match and N counts of a
    record's blocks (psl.c accumCounts, with PSL_IS_SOFTMASK)."""
    t, q = rec.pairs()
    tc, qc = t_chars[t], q_chars[q]
    n = (tc == ord("N")) | (qc == ord("N"))
    same = (tc & 0xDF) == (qc & 0xDF)
    lower = ((tc & 0x20) | (qc & 0x20)) != 0
    return [int((~n & same & ~lower).sum()), int((~n & ~same).sum()),
            int((~n & same & lower).sum()), int(n.sum())]


def _scores(rec: Record, t_chars, q_chars, lut: np.ndarray) -> int:
    t, q = rec.pairs()
    return int(lut[t_chars[t], q_chars[q]].sum())


def score_lut(matrix_acgt) -> np.ndarray:
    """(256, 256) of the configuration's matrix over letters of either
    case; N and any other letter score the matrix's least entry (lastz's
    treatment of characters outside the matrix)."""
    m = np.asarray(matrix_acgt, np.int64)
    lut = np.full((256, 256), int(m.min()), np.int64)
    for i, a in enumerate(b"ACGT"):
        for j, b in enumerate(b"ACGT"):
            for x in (a, a | 0x20):
                for y in (b, b | 0x20):
                    lut[x, y] = m[i, j]
    return lut


def _chain_scores(recs: list, scores: list, o: int, e: int) -> list:
    """The best chain score through each record of one gap window."""
    order = sorted(range(len(recs)), key=lambda i: (recs[i].t_start,
                                                    recs[i].q_start))
    ends = [(recs[i].t_end, recs[i].q_end) for i in order]
    starts = [(recs[i].t_start, recs[i].q_start) for i in order]
    s = [scores[i] for i in order]
    n = len(order)

    def link(a, b):
        dt = starts[b][0] - ends[a][0]
        dq = starts[b][1] - ends[a][1]
        if dt < 0 or dq < 0 or dt > MAX_GAP or dq > MAX_GAP:
            return None
        return 0 if dt + dq == 0 else o + e * (dt + dq - 1)

    into = list(s)
    for b in range(n):
        for a in range(b):
            c = link(a, b)
            if c is not None:
                into[b] = max(into[b], into[a] - c + s[b])
    out = list(s)
    for a in range(n - 1, -1, -1):
        for b in range(a + 1, n):
            c = link(a, b)
            if c is not None:
                out[a] = max(out[a], out[b] - c + s[a])
    best = [0] * n
    for k, i in enumerate(order):
        best[i] = into[k] + out[k] - s[k]
    return best


def _links(a: Record, b: Record) -> bool:
    """Does b follow a in one alignment: after it on both sides, at most
    MAX_GAP bases past it on each."""
    dt, dq = b.t_start - a.t_end, b.q_start - a.q_end
    return 0 <= dt <= MAX_GAP and 0 <= dq <= MAX_GAP


def _holds_seed(rec: Record, t_chars, q_chars, lut, k: int, w: int) -> bool:
    """Does the record score at least k on its own and hold w pairs in a
    row, inside one block, that match in unmasked letters on both sides."""
    t, q = rec.pairs()
    tc, qc = t_chars[t], q_chars[q]
    if int(lut[tc, qc].sum()) < k or len(t) < w:
        return False
    upper = np.isin(tc, _LETTERS) & (tc == qc)
    c = np.concatenate([[0], np.cumsum(upper)])
    block = np.repeat(np.arange(len(rec.sizes)), rec.sizes)
    full = (c[w:] - c[:-w]) == w
    return bool((full & (block[:len(full)] == block[w - 1:])).any())


def _seedless(recs: list, t_chars, q_chars, lut, k: int, w: int) -> list:
    """For each record of one gap: does its alignment (the records joined
    to it by _links, either way and on through others) hold no record that
    _holds_seed."""
    n = len(recs)
    root = list(range(n))

    def find(i):
        while root[i] != i:
            root[i] = root[root[i]]
            i = root[i]
        return i
    for a in range(n):
        for b in range(n):
            if a != b and _links(recs[a], recs[b]):
                root[find(a)] = find(b)
    seeded = {find(i) for i in range(n)
              if _holds_seed(recs[i], t_chars, q_chars, lut, k, w)}
    return [find(i) not in seeded for i in range(n)]


def _windows(workload: dict) -> np.ndarray:
    """Each gap's window (t_lo, t_hi, q_lo, q_hi), the query in + strand
    coordinates."""
    g = workload["gaps"].copy()
    chain = workload["chains"][0]
    if chain["q_strand"] == "-":
        size = chain["q_size"]
        g[:, 2], g[:, 3] = size - workload["gaps"][:, 3], \
            size - workload["gaps"][:, 2]
    return g


def check(workload: dict, config: dict, outputs: list[str]) -> list:
    """[(name, value)] of the numbers compared; each limit is the
    traffic file's."""
    p = workload["paths"]
    seqs_t = read_twobit_chars(p["t2bit"])
    seqs_q = read_twobit_chars(p["q2bit"])
    chain = workload["chains"][0]
    t_name, q_name, strand = chain["t_name"], chain["q_name"], \
        chain["q_strand"]
    t_chars = seqs_t[t_name]
    q_strand_chars = _on_strand(seqs_q[q_name], strand)
    lut = score_lut(config["score_matrix_acgt"])
    lz = config["lastz"]
    win = _windows(workload)
    malformed = outside = wrong = 0
    by_gap: dict = {}
    for w in read_psl(outputs[0]):
        try:
            rec = Record(w)
        except (ValueError, IndexError):
            malformed += 1
            continue
        if not rec.well_formed(seqs_t, seqs_q):
            malformed += 1
            continue
        k = int(np.searchsorted(win[:, 0], rec.t_start, "right")) - 1
        if (rec.t_name != t_name or rec.q_name != q_name
                or rec.strand != strand or k < 0
                or rec.t_end > win[k, 1] or rec.q_start < win[k, 2]
                or rec.q_end > win[k, 3]):
            outside += 1
            k = -1
        q_chars = _on_strand(seqs_q[rec.q_name], rec.strand)
        if _recount(rec, seqs_t[rec.t_name], q_chars) != rec.counts:
            wrong += 1
        by_gap.setdefault(k, []).append(rec)
    below = 0
    on_keys, off, hit_keys = [], 0, []
    hidden = set(int(k) for k in workload["masked"][:, 0])
    diag_keys = _planted_diagonals(workload)
    for k, recs in by_gap.items():
        pairs = [r.pairs() for r in recs]
        t = np.concatenate([x[0] for x in pairs])
        q = np.concatenate([x[1] for x in pairs])
        if k < 0:
            off += len(t)
            continue
        scores = [_scores(r, t_chars, q_strand_chars, lut) for r in recs]
        below += sum(1 for s in _chain_scores(recs, scores, lz["O"],
                                              lz["E"]) if s < lz["L"])
        on = np.isin(k * _KEY + (t - q), diag_keys)
        off += int((~on).sum())
        on_keys.append(t * _KEY + q)
        if k in hidden:
            seedless = _seedless(recs, t_chars, q_strand_chars, lut,
                                 lz["K"], lz["W"])
            hit_keys += [x[0] * _KEY + x[1]
                         for x, free in zip(pairs, seedless) if free]
    got = np.concatenate(on_keys) if on_keys else np.zeros(0, np.int64)
    unseeded = (np.concatenate(hit_keys) if hit_keys
                else np.zeros(0, np.int64))
    want = _pair_keys([r for p in workload["pieces"] for r in p])
    masked = _pair_keys(workload["masked"][:, 1:])
    missed = int((~np.isin(want, got)).sum())
    return [("psl_malformed", malformed), ("outside_gap", outside),
            ("counts_wrong", wrong), ("below_gapped_threshold", below),
            ("masked_homologs_hit", int(np.isin(masked, unseeded).sum())),
            ("homolog_missed_pct", 100.0 * missed / max(1, len(want))),
            ("pairs_off_homolog", off)]


def _pair_keys(rows) -> np.ndarray:
    """t * 2^32 + q of every planted pair of pieces (rows t, q, length)."""
    rows = np.asarray(rows, np.int64).reshape(-1, 3)
    if not len(rows):
        return np.zeros(0, np.int64)
    ar = np.arange(int(rows[:, 2].sum()), dtype=np.int64)
    first = np.cumsum(rows[:, 2]) - rows[:, 2]
    t = np.repeat(rows[:, 0] - first, rows[:, 2]) + ar
    q = np.repeat(rows[:, 1] - first, rows[:, 2]) + ar
    return t * _KEY + q


def _planted_diagonals(workload: dict) -> np.ndarray:
    """gap * 2^32 + (t - q) of every planted piece, masked ones too."""
    keys = [k * _KEY + (p[:, 0] - p[:, 1])
            for k, p in enumerate(workload["pieces"])]
    m = workload["masked"]
    keys.append(m[:, 0] * _KEY + (m[:, 1] - m[:, 2]))
    return np.concatenate(keys)


def _psl_line(t_chars, q_chars, t_name, q_name, t0, q0, n) -> str:
    """A one-block + strand record, counted as axtToPsl counts."""
    tc, qc = t_chars[t0:t0 + n], q_chars[q0:q0 + n]
    same = (tc & 0xDF) == (qc & 0xDF)
    lower = ((tc & 0x20) | (qc & 0x20)) != 0
    counts = [int((same & ~lower).sum()), int((~same).sum()),
              int((same & lower).sum()), 0]
    return "\t".join(str(x) for x in counts + [0, 0, 0, 0, "+", q_name,
                                               len(q_chars), q0, q0 + n,
                                               t_name, len(t_chars), t0,
                                               t0 + n, 1, f"{n},", f"{q0},",
                                               f"{t0},"])


def control(workload: dict, config: dict, out_dir: str, dtype) -> list[str]:
    """What seeding through the soft mask finds (the reference in the
    program's place, its seeds unmasked): every planted piece, the masked
    ones too, as one gap-free record on its planted diagonal.  dtype is
    not used: the guarantee broken is masked seeding, not a precision."""
    p = workload["paths"]
    t_chars = read_twobit_chars(p["t2bit"])["chrT"]
    q_chars = read_twobit_chars(p["q2bit"])["chrQ"]
    rows = [r for g in workload["pieces"] for r in g.tolist()]
    rows += workload["masked"][:, 1:].tolist()
    rows.sort(key=lambda r: (r[1], r[0]))
    path = os.path.join(out_dir, "control.psl")
    with open(path, "w") as f:
        for t0, q0, n in rows:
            f.write(_psl_line(t_chars, q_chars, "chrT", "chrQ", t0, q0, n)
                    + "\n")
    return [path]


def _moved(w: list) -> list:
    """A record's fields moved one base along the target, its counts
    kept."""
    w = list(w)
    w[15], w[16] = str(int(w[15]) + 1), str(int(w[16]) + 1)
    w[20] = "".join(f"{int(x) + 1}," for x in w[20].split(",") if x)
    return w


def alter(lines: list[str]) -> list[str]:
    """The longest record moved one base along the target, its counts
    kept: a record altered where it is produced."""
    recs = [ln.split("\t") for ln in lines]
    i = max(range(len(recs)), key=lambda k: int(recs[k][0])
            + int(recs[k][1]) + int(recs[k][2]) + int(recs[k][3]))
    recs[i] = _moved(recs[i])
    return ["\t".join(w) for w in recs]


def faults(workload: dict, out_dir: str, outputs: list[str]) -> dict:
    """{name: outputs} of the faults planted in the program's output and
    read beside the control: `half`, the records of the second half of the
    gaps left out; `altered`, the longest record moved one base along the
    target (alter); `shifted`, every record moved so, as an aligner whose
    target coordinates are off by one would write them."""
    with open(outputs[0]) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    cut = workload["gaps"][len(workload["gaps"]) // 2, 0]
    half = [ln for ln in lines if int(ln.split("\t")[15]) < cut]
    shifted = ["\t".join(_moved(ln.split("\t"))) for ln in lines]
    got = {}
    for name, kept in (("half", half), ("altered", alter(lines)),
                       ("shifted", shifted)):
        path = os.path.join(out_dir, f"{name}.psl")
        with open(path, "w") as f:
            f.write("".join(ln + "\n" for ln in kept))
        got[name] = [path]
    return got
