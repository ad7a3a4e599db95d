"""RepeatFiller engine: align inside chain gaps and splice the best
mini-chain back into the parent chain.

Behavioral reference: src/RepeatFiller.py.  The reference shells out one
`lastz t.2bit/chr[s..e][unmask] q.2bit/chr[s..e] | axtChain | chainSort`
pipeline per qualifying gap (make_shell_list:305-512) and then re-inserts
the best mini-chain with new flanking gap arithmetic
(insert_chain_content:669-710, fill_gaps_from_mini_chains:713-806).

Here the per-gap alignment runs in-process: ops/seed_extend finds
repeat-seeded HSPs inside the gap (lastz's role) and the kd-tree chainer +
chainConnect cleanup build the mini-chains (axtChain's role, same code
path as our axtChain engine, minScore=1000).  The splice reproduces the
reference's exact text-level semantics, including its quirks (trailing
tabs on the new gap lines, doubled newlines around inserted block rows -
harmless because every chain parser skips blank lines, kent
lineFileChopNext included).

Gap eligibility and defaults follow RepeatFiller.py:139-182: gapMin 10,
gapMax 100000 on both sides, scoreThreshold 2000.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..device import PERF
from ..device.genome import open_genome
from ..formats.chain import Chain
from ..formats.gapcalc import gap_calc_from_file
from ..formats.scorematrix import score_scheme_default
from ..ops.chain_pairs import chain_gap_hsps
from ..ops.seed_extend import GapAligner
from ..utils.profiling import phase
from .axt_chain import chain_pair, SeqPair


class GapJob:
    __slots__ = ("line_nmbr", "block_len", "t_block_end", "t_gap_end",
                 "q_block_end", "q_gap_end", "t_name", "q_name", "q_strand",
                 "q_size")

    def __init__(self, line_nmbr, block_len, t_block_end, t_gap_end,
                 q_block_end, q_gap_end, t_name, q_name, q_strand, q_size):
        self.line_nmbr = line_nmbr
        self.block_len = block_len
        self.t_block_end = t_block_end  # 1-based gap start (lastz style)
        self.t_gap_end = t_gap_end
        self.q_block_end = q_block_end  # 1-based, plus strand
        self.q_gap_end = q_gap_end
        self.t_name = t_name
        self.q_name = q_name
        self.q_strand = q_strand
        self.q_size = q_size


def harvest_gap_jobs(chain_lines: list[str],
                     chain_min_score: int = 0, chain_min_size_t: int = 0,
                     chain_min_size_q: int = 0,
                     gap_min_t: int = 10, gap_min_q: int = 10,
                     gap_max_t: int = 100000, gap_max_q: int = 100000
                     ) -> list[GapJob]:
    """make_shell_list's gap walk (RepeatFiller.py:337-489)."""
    jobs: list[GapJob] = []
    i = 0
    n = len(chain_lines)
    while i < n:
        ll = chain_lines[i].split()
        if ll and ll[0] == "chain":
            score = int(float(ll[1]))
            t_start, t_end = int(ll[5]), int(ll[6])
            q_name, q_size, q_strand = ll[7], int(ll[8]), ll[9]
            q_start, q_end = int(ll[10]), int(ll[11])
            t_name = ll[2]
            if ll[4] != "+":
                raise ValueError(f"target strand is not + for chain: {chain_lines[i]}")
            eligible = (score >= chain_min_score
                        and t_end - t_start >= chain_min_size_t
                        and q_end - q_start >= chain_min_size_q)
            cur_t, cur_q = t_start, q_start
            i += 1
            while i < n and chain_lines[i].strip() and \
                    chain_lines[i].split()[0].isdigit():
                a = chain_lines[i].split()
                if len(a) == 1:
                    i += 1
                    break
                block_len = int(a[0])
                t_block_end = cur_t + block_len
                q_block_end = cur_q + block_len
                t_gap_end = t_block_end + int(a[1])
                q_gap_end = q_block_end + int(a[2])
                t_span = t_gap_end - t_block_end
                q_span = q_gap_end - q_block_end
                if eligible and (gap_min_t <= t_span <= gap_max_t
                                 and gap_min_q <= q_span <= gap_max_q):
                    tbe, qbe = t_block_end + 1, q_block_end + 1
                    if q_strand == "-":
                        real_qbe = q_size - q_gap_end + 1
                        real_qge = q_size - qbe + 1
                    else:
                        real_qbe = qbe
                        real_qge = q_gap_end
                    jobs.append(GapJob(i, block_len, tbe, t_gap_end,
                                       real_qbe, real_qge, t_name, q_name,
                                       q_strand, q_size))
                cur_t, cur_q = t_gap_end, q_gap_end
                i += 1
        else:
            i += 1
    return jobs


def _gap_job_regions(job: GapJob, t_genome: Genome, q_genome: Genome):
    """(t_codes, q_codes, t_size, q_size, t_lo, t_hi, q_lo, q_hi) for a
    gap job; q coords in the strand's space."""
    t_codes = t_genome.codes(job.t_name, "+")
    q_codes = q_genome.codes(job.q_name, job.q_strand)
    q_size = q_genome.seq(job.q_name).size
    t_size = t_genome.seq(job.t_name).size
    # region bounds, 0-based half open
    t_lo, t_hi = job.t_block_end - 1, job.t_gap_end
    q_plus_lo, q_plus_hi = job.q_block_end - 1, job.q_gap_end
    if job.q_strand == "-":
        q_lo, q_hi = q_size - q_plus_hi, q_size - q_plus_lo
    else:
        q_lo, q_hi = q_plus_lo, q_plus_hi
    return t_codes, q_codes, t_size, q_size, t_lo, t_hi, q_lo, q_hi


def _gap_job_chains(job: GapJob, hsps: list, t_codes, q_codes,
                    t_size: int, q_size: int, scheme, gap_calc,
                    axt_chain_min_score: int) -> list[Chain]:
    """axtChain|chainSort over a gap's HSP rows (run_gap_job back half)."""
    if not hsps:
        return []
    sp = SeqPair(job.q_name, job.t_name, job.q_strand)
    sp.rows = [h[:4] for h in hsps]
    chains = chain_pair(sp, q_codes, t_codes, q_size, t_size, scheme,
                        gap_calc, axt_chain_min_score)
    chains.sort(key=lambda c: -c.score)  # chainSort
    return chains


def _gap_jobs_hsps(batch, t_genome, q_genome, aligner, prefix: str = "rf",
                   seed_codes=None):
    """(ctxs, hsps, n_problems) of the gap jobs of `batch`: each job's
    (t_codes, q_codes, t_size, q_size) and HSP rows, and the banded-DP
    problems run.  Every stage runs over the whole batch before the next,
    one phase `<prefix>: <stage>` a stage, and the problems of all the
    batch's gaps go through ONE BandExtBatch.run (and, on the card, their
    scan windows through one K4 launch: GapAligner.align_scan_batch).
    seed_codes(job), when given, returns the job's (t, q) seed codes
    (soft-masked bases at 4, seed-blind; GapAligner.align_seed)."""
    with phase(f"{prefix}: seed"):
        ctxs = []          # (t_codes, q_codes, t_size, q_size)
        seeded = []        # align_seed's regions and windows, or None
        for job in batch:
            (t_codes, q_codes, t_size, q_size,
             t_lo, t_hi, q_lo, q_hi) = _gap_job_regions(
                job, t_genome, q_genome)
            ctxs.append((t_codes, q_codes, t_size, q_size))
            t_seed, q_seed = ((None, None) if seed_codes is None
                              else seed_codes(job))
            seeded.append(aligner.align_seed(t_codes, q_codes,
                                             t_lo, t_hi, q_lo, q_hi,
                                             t_seed, q_seed))
    with phase(f"{prefix}: hsp scan"):
        blocks = aligner.align_scan_batch(seeded)
    with phase(f"{prefix}: band problems"):
        prepared = [([], None, []) if s is None
                    else aligner.align_probs(s, b)
                    for s, b in zip(seeded, blocks)]
        probs_all = [p for _, _, probs in prepared for p in probs]
    exts_all = aligner._band_batch().run(probs_all) if probs_all else []
    with phase(f"{prefix}: gapped finish"):
        hsps_all = []
        p0 = 0
        for done, state, probs in prepared:
            hsps_all.append(done if state is None else aligner.align_finish(
                state, exts_all[p0:p0 + len(probs)]))
            p0 += len(probs)
    return ctxs, hsps_all, len(probs_all)


def _gap_jobs_chains(batch, t_genome, q_genome, aligner, scheme, gap_calc,
                     axt_chain_min_score: int) -> list[list[Chain]]:
    """The mini-chains of each gap job of `batch`: its HSPs through
    _gap_jobs_hsps, then the batch chained in one phase."""
    ctxs, hsps_all, _ = _gap_jobs_hsps(batch, t_genome, q_genome, aligner)
    with phase("rf: chain"):
        chains = chain_gap_hsps(batch, hsps_all, ctxs, scheme, gap_calc,
                                axt_chain_min_score)
        if chains is not None:
            PERF["rf_chain_native_pairs"] += len(batch)
            return chains
        PERF["rf_chain_python_pairs"] += len(batch)
        return [_gap_job_chains(job, hsps, *ctx, scheme, gap_calc,
                                axt_chain_min_score)
                for job, hsps, ctx in zip(batch, hsps_all, ctxs)]


def splice_lines(job: GapJob, mini: Chain, ref_quirks: bool = False) -> str:
    """insert_chain_content (RepeatFiller.py:669-710).

    Returns the replacement text for the parent gap line.  With
    ref_quirks=True the reference's exact text is reproduced - including
    its trailing tabs, doubled newlines, and the *missing* final newline
    that makes the reference output unparseable by kent chainSort/chainRead
    ("Expecting 1 or 3 words"; verified against RepeatFiller.py run with
    the real kent binaries).  The default emits the same blocks as clean,
    parseable chain lines."""
    t_lastz_start = mini.t_start + 1
    t_lastz_end = mini.t_end
    lo_q_block_end = job.q_block_end
    lo_q_gap_end = job.q_gap_end
    if mini.q_strand == "+":
        q_lastz_start = mini.q_start + 1
        q_lastz_end = mini.q_end
    else:
        q_lastz_start = mini.q_size - mini.q_start
        q_lastz_end = mini.q_size - mini.q_end + 1
        lo_q_gap_end, lo_q_block_end = lo_q_block_end, lo_q_gap_end

    first_q_gap = abs(q_lastz_start - lo_q_block_end)
    last_q_gap = abs(lo_q_gap_end - q_lastz_end)

    body = [ln for ln in mini.to_text().split("\n")[1:] if ln.strip()]
    first_dt = t_lastz_start - job.t_block_end
    last_dt = job.t_gap_end - t_lastz_end
    if ref_quirks:
        content = [ln + "\n" for ln in body]
        block_to_add = [f"{job.block_len}\t{first_dt}\t{first_q_gap}\t"]
        for ln in content[:-1]:
            block_to_add.append(ln)
        prelast = content[-1].strip()
        block_to_add.append(f"{prelast}\t{last_dt}\t{last_q_gap}\t")
        return "\n".join(block_to_add)
    lines = [f"{job.block_len}\t{first_dt}\t{first_q_gap}"]
    lines.extend(body[:-1])
    lines.append(f"{body[-1]}\t{last_dt}\t{last_q_gap}")
    return "".join(ln + "\n" for ln in lines)


def _gap_chunks(jobs: list, chunk: int = 4096) -> list:
    """The jobs in chunks of `chunk` gaps, one band batch a chunk;
    GAT_RF_BATCH=0 gives chunks of one gap, the sequential per-gap path."""
    if os.environ.get("GAT_RF_BATCH", "1") == "0":
        chunk = 1
    return [jobs[lo:lo + chunk] for lo in range(0, len(jobs), chunk)]


def _run_gap_jobs(jobs, t_genome, q_genome, aligner, scheme, gap_calc,
                  axt_chain_min_score: int = 1000, chunk: int = 4096):
    """Yield (job, mini_chains) for every gap job.

    The reference runs one lastz process per gap sequentially
    (RepeatFiller.py:540-560).  Here the banded-DP extension problems of
    MANY gaps are concatenated and run through ONE BandExtBatch.run per
    chunk - on TPU that is one kernel dispatch for thousands of band
    DPs, instead of a ~29 ms round trip per gap; on host it is the same
    numpy loop either way (bit-identical results, the problems are
    self-contained byte strings).  GAT_RF_BATCH=0 forces the sequential
    per-gap path: a chunk of one gap."""
    for batch in _gap_chunks(jobs, chunk):
        yield from zip(batch, _gap_jobs_chains(
            batch, t_genome, q_genome, aligner, scheme, gap_calc,
            axt_chain_min_score))


@phase("repeatfiller")
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
                  device=None) -> None:
    """Full RepeatFiller pipeline over a chain file.

    device: where the gap aligner's banded DP runs (cuda unless named,
    which raises without CUDA; ops/band_batch.py).

    chain_ids: when given, only chains with these ids are processed AND
    output (the reference's --idList/--idListFile mode extracts those
    chains via chainExtractID first, RepeatFiller.py:244-302, so its
    output contains only the selected chains) - this is also the
    shard-by-chain hook for cluster fan-out."""
    with phase("rf: read + harvest"):
        with open(chain_path) as f:
            content = f.read()
        chain_lines = [ln + "\n" for ln in content.split("\n")]
        if num_shards > 1:
            # deterministic contiguous chain partition (SURVEY §5.8 /
            # patchChain.perl cluster-job fan-out): shard i keeps the exact
            # line range of its chains, so concatenating shard outputs in
            # shard order is byte-identical to a single run
            from ..parallel.distributed import shard_indices
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
        # K/L as in the reference's lastz invocation `K=1500 L=2000`
        # (RepeatFiller.py:163-169); the gapped stage joins near-diagonal HSPs
        # across indels with the banded affine DP
        aligner = GapAligner(scheme.lut, seed_len=seed_len,
                             hsp_threshold=hsp_threshold,
                             gapped_threshold=gapped_threshold,
                             gap_open=scheme.gap_open,
                             gap_extend=scheme.gap_extend,
                             char_matrix=scheme.char_matrix(),
                             device=device)

    found = list(_run_gap_jobs(jobs, t_genome, q_genome, aligner, scheme,
                               gap_calc))
    with phase("rf: splice + write"):
        replacements: dict[int, str] = {}
        for job, minis in found:
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


def repeat_filler_main(argv: list[str], device=None) -> int:
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
                   help="replicate the reference's exact (malformed) splice text")
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
        from ..utils.verbose import set_verbosity
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
