"""The hillerlab pipeline drivers (Perl/Python orchestration re-designed).

Behavioral references:
  src/patchChain.perl - sensitive re-alignment of chain gaps; the reference
      emits N shuffled csh cluster jobs running
      `lastz t.2bit/chr[s..e] q.2bit/chr[s..e] Q=HoxD55.q K=1500 L=2500 W=5
      --format=axt` + optional filterAxtIdentityEntropy + axtToPsl.  Here
      the alignment runs in-process over chunks of gaps (ops/seed_extend
      with a sensitive seed length; one band batch a chunk), with
      deterministic shard selection replacing the cluster job fan-out;
      output is the same psl patches.
  src/filterAxtIdentityEntropy.py - exact port (prefix-sum windows, greedy
      extension, whole-entry keep).
  src/ExtractSynInvChainsFromNet.perl - collect chain ids of syn/inv fills
      above thresholds; extract with chainFilter -idFile semantics.
  src/FilterChains_Net_FilterNets.perl - whole filtering pipeline:
      chainFilter sets -> (syn/inv rescue) -> chainSort -> chainPreNet ->
      chainNet -minSpace=1 -rescore -> netSyntenic -> NetFilterNonNested.
      (the reference's netClass step needs a UCSC MySQL database and is
      skipped, as the reference itself does off-host.)
"""

from __future__ import annotations

import io
import math
import os
import re
import sys

import numpy as np

from ..device import PERF
from ..device.genome import Genome
from ..formats.axt import Axt, read_axts, write_axts
from ..formats.chain import read_chains, sort_chains_by_score, write_chains
from ..formats.chromsizes import read_chrom_sizes
from ..formats.scorematrix import read_score_scheme, score_scheme_default
from ..ops.seed_extend import GapAligner
from ..utils.profiling import phase
from .chain_tools import _CharGenome, chain_filter, chain_pre_net
from .chain_net import chain_net
from .converters import axt_to_psl_records
from .net_filter_nonnested import net_filter_non_nested
from .net_tools import net_syntenic
from .repeat_filler import _gap_chunks, _gap_jobs_hsps, harvest_gap_jobs

INT_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# filterAxtIdentityEntropy
# ---------------------------------------------------------------------------

def _check_axt_entry(t_seq: str, q_seq: str, min_ident: float,
                     min_entropy: float, window: int) -> bool:
    """processHit/checkAxt: is there any window-extension passing both
    thresholds?  Exact port of the greedy scan."""
    n = len(t_seq)
    t_low = t_seq.lower()
    q_low = q_seq.lower()
    t_arr = np.frombuffer(t_low.encode(), np.uint8)
    q_arr = np.frombuffer(q_low.encode(), np.uint8)
    counts = {}
    for c in "actg":
        counts[c] = np.zeros(n + 1, np.int64)
        np.cumsum(t_arr == ord(c), out=counts[c][1:])
    matches = np.zeros(n + 1, np.int64)
    np.cumsum(t_arr == q_arr, out=matches[1:])

    def num(arr, i, j):
        return int(arr[j] - arr[i])

    def seq_ident(i, j):
        return 100.0 * num(matches, i, j) / (j - i)

    def entropy(i, j):
        vals = [float(num(counts[c], i, j)) for c in "atcg"]
        total = sum(vals)
        if total == 0:
            return 0.0
        e = 0.0
        for v in vals:
            p = v / total
            if p != 0:
                e -= p * math.log(p)
        return e / math.log(2)

    start = 0
    while start < n:
        if t_seq[start] == "-":
            start += 1
            continue
        stopped_at = -1
        for j in range(n):
            end = start + j + window
            if end > n:
                break
            if seq_ident(start, end) >= min_ident and \
                    entropy(start, end) >= min_entropy:
                stopped_at = end
            else:
                break
        if stopped_at == -1:
            start += 1
        else:
            return True
    return False


def filter_axt_identity_entropy(in_axt, min_seq_ident: float,
                                min_entropy: float, window_size: int,
                                out) -> None:
    """filterAxtIdentityEntropy.py: keep whole axt entries with at least
    one qualifying window."""
    axts = read_axts(in_axt) if isinstance(in_axt, str) else in_axt
    kept = [a for a in axts
            if _check_axt_entry(a.t_sym, a.q_sym, min_seq_ident,
                                min_entropy, window_size)]
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        # the reference writes entries verbatim (header + seqs + blank)
        for a in kept:
            f.write(f"{_axt_header(a)}\n{a.t_sym}\n{a.q_sym}\n\n")
    finally:
        if close:
            f.close()


def _axt_header(a: Axt) -> str:
    return (f"{0} {a.t_name} {a.t_start + 1} {a.t_end} {a.q_name} "
            f"{a.q_start + 1} {a.q_end} {a.q_strand} {a.score}")


# ---------------------------------------------------------------------------
# ExtractSynInvChainsFromNet
# ---------------------------------------------------------------------------

def extract_syn_inv_chains(net_file: str, chain_file: str, out,
                           keep_syn_nets_with_score: int = INT_MAX,
                           keep_inv_nets_with_score: int = INT_MAX) -> None:
    """ExtractSynInvChainsFromNet.perl: line-scan for syn/inv fills above
    the score thresholds, then extract those chain ids."""
    ids = set()
    with open(net_file) as f:
        for line in f:
            if " gap " in line or line.startswith("net ") or not line.strip():
                continue
            if " fill " not in f" {line}":
                continue
            rest = line.lstrip(" ").rstrip("\n")
            if not rest.startswith("fill"):
                continue
            w = rest.split(" ")
            # the perl's /type (\w+) / requires a TRAILING space, so a
            # fill line ending in "type syn" (netSyntenic without netClass)
            # never matches - replicated as-is for parity
            m = re.search(r"type (\w+) ", rest)
            typ = m.group(1) if m else ""
            score = int(w[10]) if len(w) > 10 else 0
            keep = ((typ == "syn" and score >= keep_syn_nets_with_score)
                    or (typ == "inv" and score >= keep_inv_nets_with_score))
            if keep:
                m = re.search(r"id (\d+) score", rest)
                if m is None:
                    raise ValueError(f"cannot parse 'id' from fill line: {rest}")
                ids.add(m.group(1))
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for chain in read_chains(chain_file):
            if str(chain.id) in ids:
                f.write(chain.to_text())
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# patchChain
# ---------------------------------------------------------------------------

@phase("patchchain")
def patch_chain(chain_file: str, t_2bit: str, q_2bit: str,
                t_sizes_file: str, q_sizes_file: str, out_psl,
                chain_min_score: int = 0, chain_min_size_t: int = 0,
                chain_min_size_q: int = 0,
                gap_min_t: int = 10, gap_min_q: int = 10,
                gap_max_t: int = 100000, gap_max_q: int = 100000,
                score_scheme: str | None = None,
                seed_len: int = 5, hsp_threshold: int = 1500,
                gapped_threshold: int = 2500,
                min_identity: float = 0, min_entropy: float = 0,
                window_size: int = 0,
                num_shards: int = 1, shard_index: int = 0,
                unmask: bool = False, device=None) -> None:
    """Sensitive re-alignment of chain gaps -> psl patches.

    device: where the gap aligner's banded DP runs (cuda unless named,
    which raises without CUDA; ops/band_batch.py).

    Replaces the reference's cluster-job fan-out: gaps are harvested with
    the same walk and bounds, round-robin sharded deterministically
    (num_shards/shard_index replace the csh jobList), aligned in-process
    a chunk of gaps at a time through RepeatFiller's stages (phases
    `pc: seed`, `pc: hsp scan`, `pc: band problems`, `pc: gapped finish`;
    one band batch a chunk, PERF["pc_band_runs"]) and written as psl
    (axtToPsl semantics).  The psl output feeds a fresh
    axtChain run exactly like the reference's patch psl files.

    unmask=False reproduces lastz's default soft-masked seeding (seeds
    cannot start in lower-case/repeat bases; extensions still score
    through them); patchChain.perl:24 appends `[unmask]` only when the
    -unmask flag is given.
    """
    if (min_entropy != 0 or min_identity != 0) and window_size == 0:
        raise ValueError("minEntropy or minIdentity given but windowSize is 0")
    with phase("pc: read + harvest"):
        with open(chain_file) as f:
            chain_lines = [ln + "\n" for ln in f.read().split("\n")]
        jobs = harvest_gap_jobs(
            chain_lines, chain_min_score, chain_min_size_t, chain_min_size_q,
            gap_min_t, gap_min_q, gap_max_t, gap_max_q)
        jobs = [j for i, j in enumerate(jobs)
                if i % num_shards == shard_index]

        scheme = (read_score_scheme(score_scheme) if score_scheme
                  else score_scheme_default())
        t_genome = Genome(t_2bit)
        q_genome = Genome(q_2bit)
        t_chars = _CharGenome(t_2bit)
        q_chars = _CharGenome(q_2bit)
        # K/L per the reference's lastz defaults for patchChain
        # (patchChain.perl:23 `K=1500 L=2500`)
        aligner = GapAligner(scheme.lut, seed_len=seed_len,
                             hsp_threshold=hsp_threshold,
                             gapped_threshold=gapped_threshold,
                             gap_open=scheme.gap_open,
                             gap_extend=scheme.gap_extend,
                             char_matrix=scheme.char_matrix(),
                             device=device)

        seed_cache: dict = {}

        def seed_codes(genome, mask_genome, name, strand):
            """Codes with soft-masked positions forced to 4 (seed-blind)."""
            key = (id(genome), name, strand)
            if key not in seed_cache:
                codes = genome.codes(name, strand).copy()
                mask = mask_genome.seq(name).mask
                if mask is not None and mask.any():
                    m = mask[::-1] if strand == "-" else mask
                    codes[m] = 4
                seed_cache[key] = codes
            return seed_cache[key]

        t_mask_genome = None if unmask else Genome(t_2bit, with_mask=True)
        q_mask_genome = None if unmask else Genome(q_2bit, with_mask=True)

        def job_seed_codes(job):
            return (seed_codes(t_genome, t_mask_genome, job.t_name, "+"),
                    seed_codes(q_genome, q_mask_genome, job.q_name,
                               job.q_strand))

    # every stage over a chunk of gaps, one band batch (K3) a chunk
    # (engines/repeat_filler.py), where the reference runs lastz a gap
    hsps_of = []
    for batch in _gap_chunks(jobs):
        _, hsps, n_probs = _gap_jobs_hsps(
            batch, t_genome, q_genome, aligner, "pc",
            None if unmask else job_seed_codes)
        hsps_of.extend(hsps)
        PERF["pc_gaps"] += len(batch)
        PERF["pc_band_problems"] += n_probs
        PERF["pc_band_runs"] += int(n_probs > 0)

    with phase("pc: axt + psl"):
        axts = []
        for job, hsps in zip(jobs, hsps_of):
            tb = t_chars.chars(job.t_name, "+")
            qb = q_chars.chars(job.q_name, job.q_strand)
            for ts, te, qs, qe, sc in hsps:
                axts.append(Axt(
                    q_name=job.q_name, q_start=qs, q_end=qe,
                    q_strand=job.q_strand, t_name=job.t_name,
                    t_start=ts, t_end=te, score=sc,
                    q_sym=qb[qs:qe].decode(), t_sym=tb[ts:te].decode()))

        if min_entropy != 0 or min_identity != 0:
            axts = [a for a in axts
                    if _check_axt_entry(a.t_sym, a.q_sym, min_identity,
                                        min_entropy, window_size)]
        psls = axt_to_psl_records(axts, read_chrom_sizes(t_sizes_file),
                                  read_chrom_sizes(q_sizes_file))
        PERF["pc_psl_records"] += len(psls)
        from ..formats.psl import write_psls
        close = isinstance(out_psl, str)
        f = open(out_psl, "w") if close else out_psl
        try:
            write_psls(psls, f)
        finally:
            if close:
                f.close()


def patch_chain_make_jobs(chain_file: str, t_2bit: str, q_2bit: str,
                          t_sizes_file: str, q_sizes_file: str,
                          num_jobs: int = 1000,
                          job_dir: str = "doPatchChain",
                          output_dir: str = "doPatchChain",
                          job_list: str = "jobList",
                          passthrough: list[str] | None = None) -> int:
    """Reference-compatible cluster fan-out (patchChain.perl:181-267):
    write numJobs executable job scripts under job_dir, each producing
    one ``output_dir/patch<i>.psl``, plus a job_list file naming them.

    Where the reference's jobs shell out to lastz | axtToPsl, ours invoke
    this framework's own patchChain in sharded mode (-numShards/-shard),
    which runs the same gap walk and writes psl directly.  The scripts
    are independent and can run in parallel on a cluster, exactly like
    the reference's csh jobs.  Returns the number of jobs written."""
    import os
    import sys as _sys
    os.makedirs(job_dir, exist_ok=True)
    os.makedirs(output_dir, exist_ok=True)
    flags = list(passthrough or [])
    # jobs may run on hosts without the package installed: pin the
    # package's parent dir onto PYTHONPATH inside each script
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import shlex
    n_written = 0
    written_paths = []
    for i in range(num_jobs):
        path = os.path.join(job_dir, f"job{i}.csh")
        out_psl = os.path.join(output_dir, f"patch{i}.psl")
        cmd = [_sys.executable, "-m", "genomealignmenttools_tpu_torch.cli.main",
               "patchChain", chain_file, t_2bit, q_2bit,
               t_sizes_file, q_sizes_file, out_psl,
               *flags, f"-numShards={num_jobs}", f"-shard={i}"]
        with open(path, "w") as f:
            f.write("#!/bin/sh -e\n")
            f.write(f'export PYTHONPATH={shlex.quote(pkg_root)}'
                    f'":${{PYTHONPATH:-}}"\n')
            f.write(f"rm -f {shlex.quote(out_psl)}\n")
            f.write("exec " + " ".join(shlex.quote(c) for c in cmd) + "\n")
        os.chmod(path, 0o755)
        n_written += 1
        written_paths.append(path)
    # list only the scripts written THIS run: stale job*.csh left from a
    # prior run with a larger -numJobs would silently duplicate psl output
    with open(job_list, "w") as f:
        for p in sorted(written_paths):
            f.write(p + "\n")
    return n_written


# ---------------------------------------------------------------------------
# FilterChains_Net_FilterNets
# ---------------------------------------------------------------------------

def filter_chains_net_filter_nets(
        in_chain: str, in_net: str, out_filtered_chain: str,
        out_filtered_net, t_2bit: str, q_2bit: str,
        t_sizes_file: str, q_sizes_file: str,
        min_scores: list[int], min_t_sizes: list[int],
        min_q_sizes: list[int],
        keep_syn_nets_with_score: int = INT_MAX,
        keep_inv_nets_with_score: int = INT_MAX,
        work_dir: str | None = None, device=None) -> None:
    """FilterChains_Net_FilterNets.perl, in-process.

    device: where chainNet -rescore scores (cuda unless named, which raises
    without CUDA; ops/rescore.py).

    chainFilter per (score, tSize, qSize) set (each excluding chrM) ->
    optional syn/inv chain rescue from the input net -> chainSort ->
    chainPreNet -> chainNet -minSpace=1 -rescore -> netSyntenic ->
    NetFilterNonNested (batch mode + syn/inv rescue).  netClass is not run
    (needs a UCSC database; the reference ships it off-host too).

    work_dir: when set, every stage checkpoints its output there and an
    interrupted run resumes at the first incomplete stage
    (utils/pipeline.py; the reference's restartability contract, SURVEY
    §5.4).
    """
    if not (len(min_scores) == len(min_t_sizes) == len(min_q_sizes)):
        raise ValueError("minScores/minTsizes/minQsizes length mismatch")
    if work_dir is not None:
        return _filter_chains_pipeline_checkpointed(
            in_chain, in_net, out_filtered_chain, out_filtered_net,
            t_2bit, q_2bit, t_sizes_file, q_sizes_file,
            min_scores, min_t_sizes, min_q_sizes,
            keep_syn_nets_with_score, keep_inv_nets_with_score, work_dir,
            device)

    filtered = io.StringIO()
    for ms, mt, mq in zip(min_scores, min_t_sizes, min_q_sizes):
        chain_filter([in_chain], filtered, not_q="chrM", not_t="chrM",
                     min_score=ms, q_min_size=mq, t_min_size=mt)
    if keep_syn_nets_with_score < INT_MAX or keep_inv_nets_with_score < INT_MAX:
        extract_syn_inv_chains(in_net, in_chain, filtered,
                               keep_syn_nets_with_score,
                               keep_inv_nets_with_score)

    # chainSort | chainPreNet
    chains = sort_chains_by_score(read_chains(io.StringIO(filtered.getvalue())))
    sorted_io = io.StringIO()
    write_chains(chains, sorted_io)
    sorted_io.seek(0)
    chain_pre_net(sorted_io, t_sizes_file, q_sizes_file, out_filtered_chain)

    # chainNet -minSpace=1 -rescore | netSyntenic
    t_net, q_sink = io.StringIO(), io.StringIO()
    chain_net(out_filtered_chain, t_sizes_file, q_sizes_file, t_net, q_sink,
              min_space=1, rescore=True, t_2bit=t_2bit, q_2bit=q_2bit,
              linear_gap="loose", device=device)
    syntenic = io.StringIO()
    net_syntenic(io.StringIO(t_net.getvalue()), syntenic)

    # NetFilterNonNested batch mode
    kw = dict(min_scores=min_scores, min_t_sizes=min_t_sizes,
              min_q_sizes=min_q_sizes)
    if keep_syn_nets_with_score < INT_MAX:
        kw["keep_syn_nets_with_score"] = keep_syn_nets_with_score
    if keep_inv_nets_with_score < INT_MAX:
        kw["keep_inv_nets_with_score"] = keep_inv_nets_with_score
    close = isinstance(out_filtered_net, str)
    f = open(out_filtered_net, "w") if close else out_filtered_net
    try:
        net_filter_non_nested(syntenic.getvalue().splitlines(), f, **kw)
    finally:
        if close:
            f.close()


def _filter_chains_pipeline_checkpointed(
        in_chain, in_net, out_filtered_chain, out_filtered_net,
        t_2bit, q_2bit, t_sizes_file, q_sizes_file,
        min_scores, min_t_sizes, min_q_sizes,
        keep_syn, keep_inv, work_dir, device=None) -> None:
    """Stage-checkpointed variant (resume-able; see utils/pipeline.py)."""
    from ..utils.pipeline import Pipeline
    if not isinstance(out_filtered_net, str):
        raise ValueError("work_dir mode requires a path for the output net")
    pl = Pipeline(work_dir)
    filtered_path = pl.path("filtered.chain")
    t_net_path = pl.path("target.rescored.net")
    syntenic_path = pl.path("syntenic.net")

    def st_filter(tmps):
        with open(tmps[0], "w") as f:
            for ms, mt, mq in zip(min_scores, min_t_sizes, min_q_sizes):
                chain_filter([in_chain], f, not_q="chrM", not_t="chrM",
                             min_score=ms, q_min_size=mq, t_min_size=mt)
            if keep_syn < INT_MAX or keep_inv < INT_MAX:
                extract_syn_inv_chains(in_net, in_chain, f, keep_syn,
                                       keep_inv)
    pl.stage("chainFilter", [in_chain, in_net], [filtered_path], st_filter)

    def st_prenet(tmps):
        chains = sort_chains_by_score(read_chains(filtered_path))
        sorted_io = io.StringIO()
        write_chains(chains, sorted_io)
        sorted_io.seek(0)
        chain_pre_net(sorted_io, t_sizes_file, q_sizes_file, tmps[0])
    pl.stage("chainSort+chainPreNet", [filtered_path], [out_filtered_chain],
             st_prenet)

    def st_net(tmps):
        with open(tmps[0], "w") as t_out:
            chain_net(out_filtered_chain, t_sizes_file, q_sizes_file,
                      t_out, io.StringIO(), min_space=1, rescore=True,
                      t_2bit=t_2bit, q_2bit=q_2bit, linear_gap="loose",
                      device=device)
    pl.stage("chainNet-rescore", [out_filtered_chain], [t_net_path], st_net)

    def st_syn(tmps):
        net_syntenic(t_net_path, tmps[0])
    pl.stage("netSyntenic", [t_net_path], [syntenic_path], st_syn)

    def st_filter_net(tmps):
        kw = dict(min_scores=min_scores, min_t_sizes=min_t_sizes,
                  min_q_sizes=min_q_sizes)
        if keep_syn < INT_MAX:
            kw["keep_syn_nets_with_score"] = keep_syn
        if keep_inv < INT_MAX:
            kw["keep_inv_nets_with_score"] = keep_inv
        with open(syntenic_path) as f, open(tmps[0], "w") as out:
            net_filter_non_nested(f.read().splitlines(), out, **kw)
    pl.stage("NetFilterNonNested", [syntenic_path], [out_filtered_net],
             st_filter_net)
