"""chainBridge engine: close similar-size double-sided gaps by banded SW.

Behavioral reference: kent/src/hg/mouseStuff/chainBridge/chainBridge.c.
Per gap: trivial extension when t and q gap sequence is identical
(canTrivialExtend/tryTrivialExtend, 96-189), ratio test canExtend
(191-221: both gaps >0, smaller <= maxGap, larger/smaller < 1.3), then a
bandExt local alignment with 5bp flanking context and maxInsert =
maxGap/10; resulting blocks are merged/trimmed into the chain
(maybeMergeBlocks/trimAndAddBlock, 223-263), and changed chains are
rescored exactly.  Sequences are lowercase (twoBitReadSeqFragLower).
"""

from __future__ import annotations

import sys

import numpy as np

from ..formats.chain import Chain, iter_chains, write_chains
from ..formats.gapcalc import gap_calc_default, gap_calc_from_file
from ..formats.scorematrix import read_score_scheme, score_scheme_default
from ..formats.twobit import TwoBitFile
from ..ops.band_ext import band_ext
from .axt_chain import _score_scheme_header
from .scoring import block_scores, chain_global_score, gap_costs


class _LowerCharGenome:
    """Lowercase char sequences per (chrom, strand) (chromStrandSeq)."""

    def __init__(self, path: str):
        self.tbf = TwoBitFile(path)
        self._cache: dict[tuple[str, str], bytes] = {}

    def chars(self, name: str, strand: str) -> bytes:
        key = (name, strand)
        if key not in self._cache:
            plus = self._cache.get((name, "+"))
            if plus is None:
                plus = self.tbf.read_seq(name).chars(do_mask=False)
                self._cache[(name, "+")] = plus
            if strand == "-":
                comp = bytes.maketrans(b"acgtn", b"tgcan")
                self._cache[key] = plus.translate(comp)[::-1]
        return self._cache[key]


def _codes_from_lower(chars: bytes) -> np.ndarray:
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"tcag"):
        lut[c] = i
    return lut[np.frombuffer(chars, np.uint8)]


def _blocks_from_sym(sym_count, q_sym: bytes, t_sym: bytes, q_pos, t_pos):
    """cBlocksFromAliSym (chain.c:95-128) on byte strings."""
    blocks = []
    cur = None
    for i in range(sym_count):
        qc = q_sym[i:i + 1]
        tc = t_sym[i:i + 1]
        if qc == b"-":
            cur = None
            t_pos += 1
        elif tc == b"-":
            cur = None
            q_pos += 1
        else:
            if cur is None:
                cur = [t_pos, t_pos, q_pos, q_pos]
                blocks.append(cur)
            q_pos += 1
            t_pos += 1
            cur[1] = t_pos
            cur[3] = q_pos
    return blocks


def _try_trivial_extend(rows, i, t_chrom: bytes, q_chrom: bytes):
    """tryTrivialExtend on row list; returns True if changed.  rows[i] and
    rows[i+1] are [tS,tE,qS,qE]."""
    changed = False
    while True:
        if i + 1 >= len(rows):
            return changed
        blk, nxt = rows[i], rows[i + 1]
        t_gap_start, t_gap_end = blk[1], nxt[0]
        q_gap_start, q_gap_end = blk[3], nxt[2]
        t_gap = t_gap_end - t_gap_start
        q_gap = q_gap_end - q_gap_start
        smaller = min(t_gap, q_gap)
        if smaller == 0:
            return changed
        if smaller < 0:
            raise ValueError("negative gap length")
        t_seq = t_chrom[t_gap_start:t_gap_start + smaller]
        q_seq = q_chrom[q_gap_start:q_gap_start + smaller]
        from_start = 0
        while from_start < smaller and t_seq[from_start] == q_seq[from_start]:
            from_start += 1
        bases_at_end = smaller - from_start
        te_seq = t_chrom[t_gap_end - bases_at_end:t_gap_end]
        qe_seq = q_chrom[q_gap_end - bases_at_end:q_gap_end]
        from_end = 0
        while from_end < bases_at_end and \
                te_seq[bases_at_end - 1 - from_end] == qe_seq[bases_at_end - 1 - from_end]:
            from_end += 1
        if from_start == t_gap and t_gap == q_gap:
            # full trivial merge
            blk[1] = nxt[1]
            blk[3] = nxt[3]
            del rows[i + 1]
            changed = True
            continue
        if from_start > 0:
            blk[1] += from_start
            blk[3] += from_start
            changed = True
        if from_end > 0:
            nxt[0] -= from_end
            nxt[2] -= from_end
            changed = True
        return changed


def _maybe_merge(blk0, blk1) -> bool:
    """maybeMergeBlocks."""
    if blk0 is None or blk1 is None:
        return False
    t_overlap = blk0[1] - blk1[0]
    q_overlap = blk0[3] - blk1[2]
    if t_overlap == q_overlap and t_overlap >= 0:
        blk0[1] = blk1[1]
        blk0[3] = blk1[3]
        return True
    return False


def _trim_and_add(new_list, blk):
    """trimAndAddBlock."""
    if new_list:
        cur = new_list[-1]
        overlap = cur[1] - blk[0]
        if overlap > 0:
            blk[0] = cur[1]
            blk[2] += overlap
        overlap = cur[3] - blk[2]
        if overlap > 0:
            blk[0] += overlap
            blk[2] = cur[3]
    if blk[1] > blk[0] and blk[3] > blk[2]:
        new_list.append(blk)


def chain_bridge(in_file: str, t_2bit: str, q_2bit: str, out,
                 max_gap: int = 6000, diff_tolerance: float = 0.3,
                 linear_gap: str | None = None,
                 score_scheme: str | None = None) -> None:
    """chainBridge tool."""
    scheme = (read_score_scheme(score_scheme) if score_scheme
              else score_scheme_default())
    gap_calc = (gap_calc_from_file(linear_gap) if linear_gap
                else gap_calc_default())
    char_matrix = scheme.char_matrix()
    t_css = _LowerCharGenome(t_2bit)
    q_css = _LowerCharGenome(q_2bit)
    overlap_ctx = 5
    max_insert = max_gap // 10

    def can_extend(rows, i):
        if i + 1 >= len(rows):
            return False
        t_gap = rows[i + 1][0] - rows[i][1]
        q_gap = rows[i + 1][2] - rows[i][3]
        if t_gap == 0 or q_gap == 0:
            return False
        smaller, larger = min(t_gap, q_gap), max(t_gap, q_gap)
        if smaller > max_gap:
            return False
        return larger / smaller < 1.0 + diff_tolerance

    chains = []
    for chain in iter_chains(in_file):
        if chain.n_blocks >= 2:
            rows = [list(map(int, r)) for r in chain.blocks]
            t_chrom = t_css.chars(chain.t_name, "+")
            q_chrom = q_css.chars(chain.q_name, chain.q_strand)
            changed = False
            new_list: list = []
            i = 0
            while i < len(rows):
                changed |= _try_trivial_extend(rows, i, t_chrom, q_chrom)
                blk = rows[i]
                if can_extend(rows, i):
                    nxt = rows[i + 1]
                    t_ali_start = blk[1] - overlap_ctx
                    t_ali_end = nxt[0] + overlap_ctx
                    q_ali_start = blk[3] - overlap_ctx
                    q_ali_end = nxt[2] + overlap_ctx
                    if (t_ali_start < 0 or t_ali_end > chain.t_size
                            or q_ali_start < 0 or q_ali_end > chain.q_size):
                        raise ValueError("chainBridge: overlap arithmetic "
                                         "out of range")
                    ok, t_sym, q_sym, _, _ = band_ext(
                        False, char_matrix, scheme.gap_open,
                        scheme.gap_extend, max_insert,
                        t_chrom[t_ali_start:t_ali_end],
                        q_chrom[q_ali_start:q_ali_end], 1)
                    if ok:
                        ext_blocks = _blocks_from_sym(
                            len(t_sym), q_sym, t_sym, q_ali_start, t_ali_start)
                        if _maybe_merge(blk, ext_blocks[0] if ext_blocks else None):
                            ext_blocks.pop(0)
                            if not ext_blocks and _maybe_merge(blk, nxt):
                                # fully bridged: splice out nxt and retry blk
                                del rows[i + 1]
                                changed = True
                                continue
                        _trim_and_add(new_list, blk)
                        if ext_blocks:
                            while len(ext_blocks) > 1:
                                _trim_and_add(new_list, ext_blocks.pop(0))
                            last_ext = ext_blocks[0]
                            if _maybe_merge(last_ext, nxt):
                                rows[i + 1] = last_ext
                            else:
                                _trim_and_add(new_list, last_ext)
                        changed = True
                        i += 1
                        continue
                _trim_and_add(new_list, blk)
                i += 1
            chain.blocks = np.array(new_list, np.int64) if new_list \
                else np.zeros((0, 4), np.int64)
            if changed:
                t_codes = _codes_from_lower(t_chrom)
                q_codes = _codes_from_lower(q_chrom)
                bs = block_scores(chain.blocks, t_codes, q_codes, scheme.lut)
                gc = gap_costs(chain.blocks, gap_calc)
                chain.score = float(chain_global_score(bs, gc))
        chains.append(chain)

    chains.sort(key=lambda c: -c.score)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        f.write(_score_scheme_header(scheme, "chainBridge"))
        write_chains(chains, f)
    finally:
        if close:
            f.close()
