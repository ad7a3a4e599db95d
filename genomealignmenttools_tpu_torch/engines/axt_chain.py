"""axtChain engine: chain gapless alignment blocks into scored chains.

Behavioral reference: kent/src/hg/mouseStuff/axtChain/axtChain.c.  Pipeline
per (tName, qName, qStrand) pair (chainPair, axtChain.c:250-309):
score blocks ungapped -> kd-tree chaining DP (chain_blocks) ->
remove partial overlaps + merge abutting -> exact rescore -> minScore
filter.  Output: score-scheme metadata header (axtScoreSchemeDnaWrite),
pass-through '#' comments from the input (unique-suppressed), chains
sorted by score.  Byte-identical to the C tool.
"""

from __future__ import annotations

import sys

import numpy as np

from ..device.genome import Genome, open_genome, revcomp_codes
from ..formats.axt import axt_to_blocks, read_axts
from ..formats.chain import Chain, write_chains
from ..formats.gapcalc import GapCalc, gap_calc_from_file
from ..formats.psl import read_psls
from ..formats.scorematrix import ScoreScheme, read_score_scheme, score_scheme_default
from .chain_connect import (connect_cost, merge_abutting,
                            remove_partial_overlaps, score_block_codes)
from .kd_chainer import chain_blocks
from .scoring import block_scores, chain_global_score, gap_costs


def _score_scheme_header(scheme: ScoreScheme, name: str) -> str:
    """axtScoreSchemeDnaWrite (axt.c)."""
    m = scheme.matrix_acgt
    vals = ",".join(str(int(v)) for v in m.ravel())
    out = [f"##matrix={name} 16 {vals}",
           f"##gapPenalties={name} O={scheme.gap_open} E={scheme.gap_extend}"]
    if scheme.extra:
        extra = scheme.extra.replace(" ", "").replace('"', "")
        out.append(f"##blastzParms={extra}")
    return "\n".join(out) + "\n"


class SeqPair:
    def __init__(self, q_name, t_name, q_strand):
        self.q_name = q_name
        self.t_name = t_name
        self.q_strand = q_strand
        self.rows: list = []  # [tS,tE,qS,qE] appended in input order


def _remove_exact_overlaps(rows: list) -> list:
    """removeExactOverlaps: sort by (q,t) start; fold duplicates."""
    rows.sort(key=lambda r: (r[2], r[0]))
    out = []
    for r in rows:
        if out and r[2] == out[-1][2] and r[0] == out[-1][0]:
            if out[-1][3] < r[3]:
                out[-1][3] = r[3]
            if out[-1][1] < r[1]:
                out[-1][1] = r[1]
        else:
            out.append(r)
    return out


def chain_pair(sp: SeqPair, q_codes, t_codes, q_size, t_size,
               scheme: ScoreScheme, gap_calc: GapCalc,
               min_score: float, details=None) -> list[Chain]:
    """chainPair: score, chain, clean up, rescore, filter."""
    lut = np.asarray(scheme.lut)
    rows = []
    for r in sp.rows:
        score = score_block_codes(q_codes, t_codes, r[2], r[0], r[1] - r[0], lut)
        rows.append([r[0], r[1], r[2], r[3], score])

    from .kd_chainer import chain_blocks_arrays
    chains = chain_blocks_arrays(sp.q_name, q_size, sp.q_strand,
                                 sp.t_name, t_size, rows,
                                 q_codes, t_codes, lut, gap_calc,
                                 details=details)
    kept = []
    for chain in chains:
        blk = [list(r[:4]) for r in chain._rows]
        blk = remove_partial_overlaps(blk, q_codes, t_codes, lut)
        blk = merge_abutting(blk)
        chain.blocks = np.array(blk, dtype=np.int64)
        chain.calc_bounds()
        bs = block_scores(chain.blocks, t_codes, q_codes, lut)
        gcs = gap_costs(chain.blocks, gap_calc)
        chain.score = float(chain_global_score(bs, gcs))
        if chain.score >= min_score:
            kept.append(chain)
    return kept


def axt_chain(in_path: str, t_seq_src: str, q_seq_src: str, out_path,
              linear_gap: str, score_scheme: str | None = None,
              min_score: int = 1000, is_psl: bool = False,
              fa_t: bool = False, fa_q: bool = False,
              details_path: str | None = None) -> None:
    """Full axtChain run, byte-identical output.

    Sequence sources follow the reference's loading rules
    (axtChain.c:119-171, 395-456): a 2bit file, a directory of .nib files
    ({dir}/{name}.nib), or - with fa_t/fa_q (the -faT/-faQ flags) - a
    fasta file whose records are loaded up front."""
    scheme = (read_score_scheme(score_scheme) if score_scheme
              else score_scheme_default())
    gap_calc = gap_calc_from_file(linear_gap)
    t_genome = open_genome(t_seq_src, fasta=fa_t)
    q_genome = open_genome(q_seq_src, fasta=fa_q)

    meta: list[str] = []
    pairs: dict[str, SeqPair] = {}
    order: list[SeqPair] = []

    if is_psl:
        for psl in read_psls(in_path, meta_out=meta):
            if len(psl.strand) > 1:
                raise ValueError(
                    f"requires PSLs with implicit positive strand: {psl.strand}")
            key = f"{psl.q_name}{psl.strand}{psl.t_name}"
            sp = pairs.get(key)
            if sp is None:
                sp = SeqPair(psl.q_name, psl.t_name, psl.strand[0])
                pairs[key] = sp
                order.append(sp)
            for i in range(psl.block_count):
                size = int(psl.block_sizes[i])
                qs = int(psl.q_starts[i])
                ts = int(psl.t_starts[i])
                sp.rows.append([ts, ts + size, qs, qs + size])
        # psl path: spList order is reverse first-occurrence (slAddHead,
        # no sort - axtChain.c:375)
        order.reverse()
    else:
        for a in read_axts(in_path, meta_out=meta):
            key = f"{a.q_name}{a.q_strand}{a.t_name}"
            sp = pairs.get(key)
            if sp is None:
                sp = SeqPair(a.q_name, a.t_name, a.q_strand)
                pairs[key] = sp
                order.append(sp)
            for b in axt_to_blocks(a):
                sp.rows.append([int(b[0]), int(b[1]), int(b[2]), int(b[3])])
        # axt path sorts pairs by (tName, qName, strand) (seqPairCmp)
        order.sort(key=lambda s: (s.t_name, s.q_name, s.q_strand))

    close = False
    if isinstance(out_path, str):
        out = open(out_path, "w")
        close = True
    else:
        out = out_path
    try:
        out.write(_score_scheme_header(scheme, "axtChain"))
        # unique metadata passthrough (lineFileSetUniqueMetaData)
        seen = set()
        for line in meta:
            if line not in seen:
                seen.add(line)
                out.write(line + "\n")

        details = open(details_path, "w") if details_path else None
        all_chains: list[Chain] = []
        for sp in order:
            sp.rows = _remove_exact_overlaps(sp.rows)
            t_codes = t_genome.codes(sp.t_name, "+")
            q_codes = q_genome.codes(sp.q_name, sp.q_strand)
            q_size = q_genome.seq(sp.q_name).size
            t_size = t_genome.seq(sp.t_name).size
            kept = chain_pair(sp, q_codes, t_codes, q_size, t_size,
                              scheme, gap_calc, min_score, details=details)
            # slAddHead per chain onto the master list -> most recent pair
            # first, each pair's chains reversed; final sort is stable desc
            all_chains = kept[::-1] + all_chains
        all_chains.sort(key=lambda c: -c.score)
        next_id = 1
        for chain in all_chains:
            if chain.id == 0:
                chain.id = next_id
                next_id += 1
        write_chains(all_chains, out)
        if details is not None:
            details.close()
    finally:
        if close:
            out.close()


def axt_chain_main(argv: list[str]) -> int:
    from ..cli.main import _parse_kent_args
    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: axtChain [-psl] [-faT] [-faQ] -linearGap=loose in.axt "
              "tSeq qSeq out.chain [-minScore=N] [-scoreScheme=file] "
              "(tSeq/qSeq: 2bit | nib dir | fasta with -faT/-faQ)",
              file=sys.stderr)
        return 255
    axt_chain(pos[0], pos[1], pos[2], pos[3],
              linear_gap=opts.get("linearGap", ""),
              score_scheme=opts.get("scoreScheme"),
              min_score=int(opts.get("minScore", 1000)),
              is_psl="psl" in opts,
              fa_t="faT" in opts, fa_q="faQ" in opts,
              details_path=opts.get("details"))
    return 0
