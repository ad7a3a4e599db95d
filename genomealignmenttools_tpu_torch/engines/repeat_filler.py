"""RepeatFiller with the port's gap aligner.

Counterpart of genomealignmenttools_tpu/engines/repeat_filler.py.  The
reference engine builds its GapAligner itself (repeat_filler.py:302), so
`repeat_filler` and `repeat_filler_main` are copies of repeat_filler.py:
243-328 and 331-404 with one change: the aligner is a TorchGapAligner on
`device`, whose banded extension DP runs K3 on CUDA (its plain version on
the CPU).  The gap walk (`harvest_gap_jobs`), the cross-gap batching
(`_run_gap_jobs`, which takes the aligner), the splice (`splice_lines`),
the genomes, the score scheme and the gap costs are the reference's own.
"""

from __future__ import annotations

import sys

import torch

from genomealignmenttools_tpu.device.genome import open_genome
from genomealignmenttools_tpu.engines.repeat_filler import (
    _run_gap_jobs, harvest_gap_jobs, splice_lines)
from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default

from ..ops.seed_extend import TorchGapAligner


def repeat_filler(chain_path: str, t_2bit: str, q_2bit: str, out,
                  chain_min_score: int = 0, chain_min_size_t: int = 0,
                  chain_min_size_q: int = 0,
                  gap_min_t: int = 10, gap_min_q: int = 10,
                  gap_max_t: int = 100000, gap_max_q: int = 100000,
                  score_threshold: int = 2000,
                  seed_len: int = 6, hsp_threshold: int = 1500,
                  gapped_threshold: int = 2000,
                  ref_quirks: bool = False,
                  chain_ids: set[int] | None = None,
                  num_shards: int = 1, shard: int = 0,
                  device: str | torch.device | None = None) -> None:
    """Full RepeatFiller pipeline over a chain file (repeat_filler.py:
    243-328), with the gap aligner's band DP on `device`."""
    with open(chain_path) as f:
        content = f.read()
    chain_lines = [ln + "\n" for ln in content.split("\n")]
    if num_shards > 1:
        from genomealignmenttools_tpu.parallel.distributed import \
            shard_indices
        starts = [i for i, ln in enumerate(chain_lines)
                  if ln.startswith("chain ")]
        idx = shard_indices(len(starts), num_shards, shard)
        lo = starts[idx.start] if idx.start < len(starts) else len(chain_lines)
        if shard == 0:
            lo = 0  # prelude (meta/blank) lines belong to the first shard
        hi = starts[idx.stop] if idx.stop < len(starts) else len(chain_lines)
        chain_lines = chain_lines[lo:hi]
    if chain_ids is not None:
        kept: list[str] = []
        keep = False
        for ln in chain_lines:
            if ln.startswith("chain "):
                w = ln.split()
                keep = len(w) >= 13 and int(w[12]) in chain_ids
                if keep and kept:
                    kept.append("\n")  # blank separator between chains
            if keep and ln.strip() != "":
                kept.append(ln)
        kept.append("\n")
        chain_lines = kept
    jobs = harvest_gap_jobs(
        chain_lines, chain_min_score, chain_min_size_t, chain_min_size_q,
        gap_min_t, gap_min_q, gap_max_t, gap_max_q)

    scheme = score_scheme_default()
    gap_calc = gap_calc_from_file("loose")
    t_genome = open_genome(t_2bit)
    q_genome = open_genome(q_2bit)
    aligner = TorchGapAligner(scheme.lut, seed_len=seed_len,
                              hsp_threshold=hsp_threshold,
                              gapped_threshold=gapped_threshold,
                              gap_open=scheme.gap_open,
                              gap_extend=scheme.gap_extend,
                              char_matrix=scheme.char_matrix(),
                              device=device)

    replacements: dict[int, str] = {}
    for job, minis in _run_gap_jobs(jobs, t_genome, q_genome, aligner,
                                    scheme, gap_calc):
        if not minis:
            continue
        best = minis[0]
        # the reference compares the chainSort header's printed score
        if int(float(f"{best.score:.0f}")) >= score_threshold:
            replacements[job.line_nmbr] = splice_lines(job, best, ref_quirks)

    close = False
    if isinstance(out, str):
        out = open(out, "w")
        close = True
    try:
        for i, line in enumerate(chain_lines):
            out.write(replacements.get(i, line))
    finally:
        if close:
            out.close()


def repeat_filler_main(argv: list[str],
                       device: str | torch.device | None = None) -> int:
    """The RepeatFiller command line (repeat_filler.py:331-404)."""
    import argparse
    p = argparse.ArgumentParser(prog="RepeatFiller")
    p.add_argument("-c", "--chain", required=True)
    p.add_argument("-T2", "--T2bit", required=True)
    p.add_argument("-Q2", "--Q2bit", required=True)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-mscore", "--chainMinScore", type=int, default=0)
    p.add_argument("-mst", "--chainMinSizeT", type=int, default=0)
    p.add_argument("-msq", "--chainMinSizeQ", type=int, default=0)
    p.add_argument("-gmint", "--gapMinSizeT", type=int, default=10)
    p.add_argument("-gminq", "--gapMinSizeQ", type=int, default=10)
    p.add_argument("-gmaxt", "--gapMaxSizeT", type=int, default=100000)
    p.add_argument("-gmaxq", "--gapMaxSizeQ", type=int, default=100000)
    p.add_argument("-st", "--scoreThreshold", type=int, default=2000)
    p.add_argument("--seedLen", type=int, default=6)
    p.add_argument("--hspThreshold", type=int, default=1500)
    p.add_argument("--refQuirks", action="store_true",
                   help="replicate the reference's exact (malformed) "
                        "splice text")
    p.add_argument("--idList", type=str, default=None,
                   help="comma-separated chain ids to patch (only those "
                        "chains are output, like the reference)")
    p.add_argument("--idListFile", type=str, default=None)
    p.add_argument("-lparam", "--lastzParameters", type=str,
                   default=None,
                   help="lastz-style 'K=... W=...' string; K maps to "
                        "hspThreshold, W to seedLen")
    # accepted for drop-in compatibility; meaningless in-process
    p.add_argument("--index", "-ix", type=str, default=None)
    p.add_argument("--workdir", "-w", type=str, default=None)
    p.add_argument("-l", "--lastz", "-x", "--axtChain", "-s",
                   "--chainSort", "-cid", "--chainExtractID",
                   "--chainSort", type=str, default=None,
                   help="external binary paths (unused: in-process)")
    p.add_argument("-um", "--unmask", action="store_true",
                   help="align ignoring soft-mask (always on: the seed/"
                        "extend stage works on unmasked codes)")
    p.add_argument("--numShards", type=int, default=1,
                   help="deterministic contiguous chain partition; concat "
                        "of shard outputs == single-run output")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args(argv)
    if a.verbose:
        from genomealignmenttools_tpu.utils.verbose import set_verbosity
        set_verbosity(2)
    if a.idList and a.idListFile:
        p.error("choose either idList or idListFile, not both")
    chain_ids = None
    if a.idList:
        chain_ids = {int(x) for x in a.idList.split(",") if x}
    elif a.idListFile:
        with open(a.idListFile) as f:
            chain_ids = {int(x) for x in f.read().split() if x}
    if a.lastzParameters:
        import re as _re
        mk = _re.search(r"K\s*=\s*(\d+)", a.lastzParameters)
        mw = _re.search(r"W\s*=\s*(\d+)", a.lastzParameters)
        if mk:
            a.hspThreshold = int(mk.group(1))
        if mw:
            a.seedLen = int(mw.group(1))
    out = a.output if a.output else sys.stdout
    repeat_filler(a.chain, a.T2bit, a.Q2bit, out,
                  chain_min_score=a.chainMinScore,
                  chain_min_size_t=a.chainMinSizeT,
                  chain_min_size_q=a.chainMinSizeQ,
                  gap_min_t=a.gapMinSizeT, gap_min_q=a.gapMinSizeQ,
                  gap_max_t=a.gapMaxSizeT, gap_max_q=a.gapMaxSizeQ,
                  num_shards=a.numShards, shard=a.shard,
                  score_threshold=a.scoreThreshold,
                  seed_len=a.seedLen, hsp_threshold=a.hspThreshold,
                  ref_quirks=a.refQuirks, chain_ids=chain_ids,
                  device=device)
    return 0
