"""lav converters: lavToPsl and lavToAxt.

Behavioral references:
- kent/src/hg/mouseStuff/lavToPsl/lavToPsl.c (outputBlocks:31, parseA:126,
  parseIntoPsl:181) with -target-strand / -bed / -scoreFile options.
- kent/src/hg/mouseStuff/lavToAxt/lavToAxt.c (outputBlocks:159, parseA:320,
  breakUpIfOnDiagonal:372, parseIntoAxt:425) with nib-dir / 2bit / fasta
  sequence sources and -dropSelf self-alignment splitting.
- kent/src/lib/basicBed.c bedFromPsl:713 + bedOutFlexible for -bed output,
  kent/src/lib/psl.c pslCalcMilliBad:754 for the bed score.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..formats.lav import (LavBlock, LineCursor, parse_d, parse_h, parse_s,
                           remove_frayed_ends, seek_end_of_stanza)
from ..formats.psl import Psl
from ..formats.scorematrix import read_score_scheme, score_scheme_default
from ..formats.twobit import TwoBitFile, is_twobit_file

BIGNUM = 0x3FFFFFFF


def _c_round(x: float) -> int:
    """C round(): half away from zero (inputs here are non-negative)."""
    return int(math.floor(x + 0.5))


# ---------------------------------------------------------------- lavToPsl

def _psl_calc_milli_bad(psl: Psl, is_mrna: bool) -> int:
    """pslCalcMilliBad (psl.c:754-786), DNA case (sizeMul == 1)."""
    q_ali = psl.q_end - psl.q_start
    t_ali = psl.t_end - psl.t_start
    ali = min(q_ali, t_ali)
    if ali <= 0:
        return 0
    size_dif = q_ali - t_ali
    if size_dif < 0:
        size_dif = 0 if is_mrna else -size_dif
    insert_factor = psl.q_num_insert
    if not is_mrna:
        insert_factor += psl.t_num_insert
    total = psl.matches + psl.rep_matches + psl.mis_matches
    if total == 0:
        return 0
    return (1000 * (psl.mis_matches + insert_factor
                    + _c_round(3 * math.log(1 + size_dif)))) // total


def _bed12_from_psl(psl: Psl) -> str:
    """bedFromPsl + bedTabOutN(bed, 12) (basicBed.c:713-763, 655)."""
    if (psl.q_start >= psl.q_end or psl.q_end > psl.q_size
            or psl.t_start >= psl.t_end or psl.t_end > psl.t_size):
        raise ValueError(f"mangled psl format for {psl.q_name}")
    chrom_start = psl.t_start
    score = 1000 - 2 * _psl_calc_milli_bad(psl, True)
    if score < 0:
        score = 0
    strand = psl.strand[0]
    sizes = [int(v) for v in psl.block_sizes]
    starts = [int(v) for v in psl.t_starts]
    if len(psl.strand) > 1 and psl.strand[1] == "-":
        sizes.reverse()
        starts.reverse()
        starts = [psl.t_size - s - sz for s, sz in zip(starts, sizes)]
        strand = "+" if strand == "-" else "-"
    rel = [s - chrom_start for s in starts]
    return ("\t".join([
        psl.t_name, str(chrom_start), str(psl.t_end), psl.q_name, str(score),
        strand, str(chrom_start), str(psl.t_end), "0", str(len(sizes)),
        "".join(f"{v}," for v in sizes), "".join(f"{v}," for v in rel),
    ]) + "\n")


def _psl_from_lav_blocks(blocks: list[LavBlock], is_rc: bool, q_name: str,
                         q_size: int, t_name: str, t_size: int,
                         target_strand: str) -> Psl:
    """lavToPsl outputBlocks (lavToPsl.c:31-124)."""
    match = mismatch = 0
    q_num_ins = q_base_ins = t_num_ins = t_base_ins = 0
    last = None
    for blk in blocks:
        scale = 0.01 * blk.percent_id
        bases = blk.q_end - blk.q_start
        match_one = _c_round(scale * bases)
        match += match_one
        mismatch += bases - match_one
        if last is not None:
            if blk.q_start != last.q_end:
                q_num_ins += 1
                q_base_ins += blk.q_start - last.q_end
            if blk.t_start != last.t_end:
                t_num_ins += 1
                t_base_ins += blk.t_start - last.t_end
        last = blk
    q_total_start, t_total_start = blocks[0].q_start, blocks[0].t_start
    q_total_end, t_total_end = blocks[-1].q_end, blocks[-1].t_end
    strand = ("-" if is_rc else "+") + (target_strand[:1] if target_strand
                                        else "")
    return Psl(
        matches=match, mis_matches=mismatch, rep_matches=0, n_count=0,
        q_num_insert=q_num_ins, q_base_insert=q_base_ins,
        t_num_insert=t_num_ins, t_base_insert=t_base_ins, strand=strand,
        q_name=q_name, q_size=q_size,
        q_start=(q_size - q_total_end) if is_rc else q_total_start,
        q_end=(q_size - q_total_start) if is_rc else q_total_end,
        t_name=t_name, t_size=t_size, t_start=t_total_start,
        t_end=t_total_end, block_count=len(blocks),
        block_sizes=np.array([b.t_end - b.t_start for b in blocks], np.int64),
        q_starts=np.array([b.q_start for b in blocks], np.int64),
        t_starts=np.array([b.t_start for b in blocks], np.int64))


def _parse_a_psl(cur: LineCursor, score_out) -> list[LavBlock]:
    """lavToPsl parseA (lavToPsl.c:126-179): zero-length 'l' records are
    dropped; every 's' line echoes its raw score to the score side-file."""
    blocks: list[LavBlock] = []
    score = 0
    while True:
        line = cur.next()
        if line is None or line.startswith("}"):
            break
        if line.startswith("#"):
            continue
        words = line.split()
        if not words:
            continue
        if words[0][0] == "s":
            if len(words) != 2:
                raise ValueError(f"Expecting 2 words in {cur.name}")
            score = int(words[1]) - 1
        if words[0][0] == "l":
            if len(words) != 6:
                raise ValueError(f"Expecting 6 words in {cur.name}")
            blk = LavBlock(
                t_start=int(words[1]) - 1, t_end=int(words[3]),
                q_start=int(words[2]) - 1, q_end=int(words[4]),
                percent_id=int(words[5]), score=score)
            if blk.q_end - blk.q_start != blk.t_end - blk.t_start:
                raise ValueError(f"Block size mismatch in {cur.name}")
            if not (blk.q_end == blk.q_start and blk.t_end == blk.t_start):
                blocks.append(blk)
        if score_out is not None and words[0][0] == "s":
            score_out.write(f"{int(words[1])}\n")
    return remove_frayed_ends(blocks)


def lav_to_psl(in_lav: str, out, target_strand: str = "",
               bed: bool = False, score_file: str | None = None) -> None:
    """lavToPsl tool (default target_strand is empty, matching
    optionVal("target-strand", "") in lavToPsl.c:245)."""
    with open(in_lav) as f:
        lines = f.read().splitlines()
    cur = LineCursor(lines, in_lav)
    first = cur.next()
    if first is None:
        raise ValueError(f"{in_lav} is empty")
    if not first.startswith("#:lav"):
        raise ValueError(f"{in_lav} is not a lav file")

    close = isinstance(out, str)
    f = open(out, "w") if close else out
    ff = open(score_file, "w") if score_file else None
    t_name = q_name = None
    t_size = q_size = 0
    is_rc = False
    try:
        while True:
            line = cur.next()
            if line is None:
                break
            if line.startswith("s {"):
                t_size, q_size = parse_s(cur)
            elif line.startswith("h {"):
                t_name, q_name, is_rc = parse_h(cur)
            elif line.startswith("d {"):
                parse_d(cur, f)
            elif line.startswith("a {"):
                blocks = _parse_a_psl(cur, ff)
                if blocks:
                    psl = _psl_from_lav_blocks(blocks, is_rc, q_name, q_size,
                                               t_name, t_size, target_strand)
                    if bed:
                        f.write(_bed12_from_psl(psl))
                    else:
                        f.write(psl.to_line() + "\n")
    finally:
        if ff is not None:
            ff.close()
        if close:
            f.close()


# ---------------------------------------------------------------- lavToAxt


def _read_fasta_mixed(path: str) -> dict[str, bytes]:
    """faReadAllMixed: fasta with case preserved; name is the first word."""
    seqs: dict[str, bytes] = {}
    name = None
    chunks: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(chunks).encode()
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        seqs[name] = "".join(chunks).encode()
    return seqs


class _SeqSource:
    """Sequence fetch with caching: a 2bit file, a directory of nib files,
    or a fasta file (openFromCache/readFromCache, lavToAxt.c:120-156)."""

    def __init__(self, spec: str, is_fa: bool):
        self.spec = spec
        self.is_fa = is_fa
        self.tbf = None
        self._fa: dict[str, bytes] | None = None
        self._cache: dict[str, bytes] = {}
        if is_fa:
            self._fa = _read_fasta_mixed(spec)
        elif is_twobit_file(spec):
            self.tbf = TwoBitFile(spec)

    def _chrom(self, name: str) -> bytes:
        if name not in self._cache:
            if self._fa is not None:
                if name not in self._fa:
                    raise ValueError(f"sequence not found {name}")
                self._cache[name] = self._fa[name]
            elif self.tbf is not None:
                self._cache[name] = self.tbf.read_seq(name).chars(do_mask=True)
            else:
                from ..formats.nib import read_nib
                self._cache[name] = read_nib(f"{self.spec}/{name}.nib")
        return self._cache[name]

    def fetch(self, name: str, start: int, end: int) -> bytes:
        return self._chrom(name)[start:end]


_COMP = bytes.maketrans(b"acgtACGT", b"tgcaTGCA")


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def _parse_a_axt(cur: LineCursor) -> tuple[list[LavBlock], int]:
    """lavToAxt parseA (lavToAxt.c:320-369): keeps zero-length middle
    blocks; the score line is required."""
    blocks: list[LavBlock] = []
    score = None
    while True:
        line = cur.next()
        if line is None or line.startswith("}"):
            break
        if line.startswith("#"):
            continue
        words = line.split()
        if not words:
            continue
        if words[0][0] == "l":
            if len(words) != 6:
                raise ValueError(f"Expecting 6 words in {cur.name}")
            blk = LavBlock(
                t_start=int(words[1]) - 1, t_end=int(words[3]),
                q_start=int(words[2]) - 1, q_end=int(words[4]),
                percent_id=int(words[5]))
            if blk.q_end - blk.q_start != blk.t_end - blk.t_start:
                raise ValueError(f"Block size mismatch in {cur.name}")
            blocks.append(blk)
        elif words[0][0] == "s":
            score = int(words[1])
    if score is None:
        raise ValueError(f"'a' stanza missing score in {cur.name}")
    return remove_frayed_ends(blocks), score


def _break_up_if_on_diagonal(blocks: list[LavBlock], is_rc: bool,
                             q_name: str, t_name: str, q_size: int
                             ) -> tuple[list[list[LavBlock]], bool]:
    """breakUpIfOnDiagonal (lavToAxt.c:372-423): for self alignments, drop
    blocks whose t range intersects their (strand-resolved) q range and
    split the list around them.  Returns (segments, broken_up)."""
    if q_name != t_name:
        return [blocks], False
    broken = False
    segs: list[list[LavBlock]] = []
    cur: list[LavBlock] = []
    for blk in blocks:
        q_start, q_end = blk.q_start, blk.q_end
        if is_rc:
            q_start, q_end = q_size - q_end, q_size - q_start
        if min(blk.t_end, q_end) - max(blk.t_start, q_start) > 0:
            broken = True
            if cur:
                segs.append(cur)
                cur = []
        else:
            cur.append(blk)
    if cur:
        segs.append(cur)
    if not segs:
        return [], broken
    return [remove_frayed_ends(s) for s in segs], broken


def _output_axt_blocks(blocks: list[LavBlock], score: int, f, is_rc: bool,
                       q_name: str, q_size: int, q_src: _SeqSource,
                       t_name: str, t_size: int, t_src: _SeqSource,
                       rescore: bool, scheme, axt_ix: list[int]) -> None:
    """lavToAxt outputBlocks (lavToAxt.c:159-318)."""
    if not blocks:
        return
    q_start = min(b.q_start for b in blocks)
    q_end = max(b.q_end for b in blocks)
    t_start = min(b.t_start for b in blocks)
    t_end = max(b.t_end for b in blocks)

    if is_rc:
        fs, fe = q_size - q_end, q_size - q_start
        q_seq = _revcomp(q_src.fetch(q_name, fs, fe))
    else:
        q_seq = q_src.fetch(q_name, q_start, q_end)
    t_seq = t_src.fetch(t_name, t_start, t_end)

    q_sym = bytearray()
    t_sym = bytearray()
    last = None
    for blk in blocks:
        if last is not None:
            q_gap = blk.q_start - last.q_end
            t_gap = blk.t_start - last.t_end
            if q_gap != 0 and t_gap != 0:
                raise ValueError("Gaps in both strands in lav alignment")
            if q_gap > 0:
                t_sym += b"-" * q_gap
                q_sym += q_seq[last.q_end - q_start:last.q_end - q_start
                               + q_gap]
            if t_gap > 0:
                q_sym += b"-" * t_gap
                t_sym += t_seq[last.t_end - t_start:last.t_end - t_start
                               + t_gap]
        q_sym += q_seq[blk.q_start - q_start:blk.q_end - q_start]
        t_sym += t_seq[blk.t_start - t_start:blk.t_end - t_start]
        last = blk
    if len(q_sym) != len(t_sym):
        raise ValueError("qSize and tSize don't agree in lav alignment")

    if rescore:
        from .chain_tools import _axt_score_sym
        score = _axt_score_sym(q_sym.decode(), t_sym.decode(),
                               scheme.char_matrix(), scheme.gap_open,
                               scheme.gap_extend)

    f.write(f"{axt_ix[0]} {t_name} {t_start + 1} {t_end} {q_name} "
            f"{q_start + 1} {q_end} {'-' if is_rc else '+'} {score}\n")
    f.write(t_sym.decode() + "\n")
    f.write(q_sym.decode() + "\n")
    f.write("\n")
    axt_ix[0] += 1


def lav_to_axt(in_lav: str, t_seq_spec: str, q_seq_spec: str, out,
               q_is_fa: bool = False, t_is_fa: bool = False,
               drop_self: bool = False,
               score_scheme: str | None = None) -> None:
    """lavToAxt tool.  t_seq_spec/q_seq_spec are a nib dir, a 2bit file,
    or (with the fa flags) a fasta file."""
    scheme = (read_score_scheme(score_scheme) if score_scheme
              else score_scheme_default())
    t_src = _SeqSource(t_seq_spec, t_is_fa)
    q_src = _SeqSource(q_seq_spec, q_is_fa)

    with open(in_lav) as f:
        lines = f.read().splitlines()
    cur = LineCursor(lines, in_lav)
    first = cur.next()
    if first is None:
        raise ValueError(f"{in_lav} is empty")
    if not first.startswith("#:lav"):
        raise ValueError(f"{in_lav} is not a lav file")

    close = isinstance(out, str)
    f = open(out, "w") if close else out
    t_name = q_name = None
    t_size = q_size = 0
    is_rc = False
    axt_ix = [0]
    try:
        while True:
            line = cur.next()
            if line is None:
                break
            if line.startswith("s {"):
                t_size, q_size = parse_s(cur)
            elif line.startswith("h {"):
                t_name, q_name, is_rc = parse_h(cur)
            elif line.startswith("d {"):
                parse_d(cur, f)
            elif line.startswith("a {"):
                blocks, score = _parse_a_axt(cur)
                if drop_self:
                    segs, rescore = _break_up_if_on_diagonal(
                        blocks, is_rc, q_name, t_name, q_size)
                    for seg in segs:
                        _output_axt_blocks(seg, score, f, is_rc, q_name,
                                           q_size, q_src, t_name, t_size,
                                           t_src, rescore, scheme, axt_ix)
                else:
                    _output_axt_blocks(blocks, score, f, is_rc, q_name,
                                       q_size, q_src, t_name, t_size, t_src,
                                       False, scheme, axt_ix)
    finally:
        if close:
            f.close()
