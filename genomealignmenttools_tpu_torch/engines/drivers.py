"""patchChain and FilterChains_Net_FilterNets on the port's device.

Counterpart of patch_chain and filter_chains_net_filter_nets in
genomealignmenttools_tpu/engines/drivers.py.

- The reference builds its GapAligner itself (drivers.py:224), so
  `patch_chain` is a copy of drivers.py:181-289 with one change: the aligner
  is a TorchGapAligner on `device` (K3 on CUDA, its plain version on the
  CPU).  As in the reference, each gap runs its own align() and with it one
  band batch.  The gap walk, the axt entry filter, the axt-to-psl
  conversion and the psl writer are the reference's own.
- The reference's filtering pipeline calls chain_net(..., rescore=True)
  without a scorer factory (drivers.py:397-399, 454-456), which scores on
  the host.  `filter_chains_net_filter_nets` and its checkpointed variant
  are copies of drivers.py:348-474 with one change: both chain_net calls
  take scorer_factory=torch_scorer_factory(device), so the rescoring runs
  K1 on CUDA.  chainFilter, chainPreNet, netSyntenic and NetFilterNonNested
  are the reference's own.
"""

from __future__ import annotations

import io

import torch

from genomealignmenttools_tpu.device.genome import Genome
from genomealignmenttools_tpu.engines.chain_net import chain_net
from genomealignmenttools_tpu.engines.chain_tools import (
    _CharGenome, chain_filter, chain_pre_net)
from genomealignmenttools_tpu.engines.converters import axt_to_psl_records
from genomealignmenttools_tpu.engines.drivers import (
    INT_MAX, _check_axt_entry, extract_syn_inv_chains)
from genomealignmenttools_tpu.engines.net_filter_nonnested import \
    net_filter_non_nested
from genomealignmenttools_tpu.engines.net_tools import net_syntenic
from genomealignmenttools_tpu.engines.repeat_filler import harvest_gap_jobs
from genomealignmenttools_tpu.formats.axt import Axt
from genomealignmenttools_tpu.formats.chain import (
    read_chains, sort_chains_by_score, write_chains)
from genomealignmenttools_tpu.formats.chromsizes import read_chrom_sizes
from genomealignmenttools_tpu.formats.psl import write_psls
from genomealignmenttools_tpu.formats.scorematrix import (
    read_score_scheme, score_scheme_default)

from ..ops.rescore import torch_scorer_factory
from ..ops.seed_extend import TorchGapAligner


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
                unmask: bool = False,
                device: str | torch.device | None = None) -> None:
    """Sensitive re-alignment of chain gaps -> psl patches (drivers.py:
    181-289), with the gap aligner's band DP on `device`."""
    if (min_entropy != 0 or min_identity != 0) and window_size == 0:
        raise ValueError("minEntropy or minIdentity given but windowSize is 0")
    with open(chain_file) as f:
        chain_lines = [ln + "\n" for ln in f.read().split("\n")]
    jobs = harvest_gap_jobs(
        chain_lines, chain_min_score, chain_min_size_t, chain_min_size_q,
        gap_min_t, gap_min_q, gap_max_t, gap_max_q)
    jobs = [j for i, j in enumerate(jobs) if i % num_shards == shard_index]

    scheme = (read_score_scheme(score_scheme) if score_scheme
              else score_scheme_default())
    t_genome = Genome(t_2bit)
    q_genome = Genome(q_2bit)
    t_chars = _CharGenome(t_2bit)
    q_chars = _CharGenome(q_2bit)
    aligner = TorchGapAligner(scheme.lut, seed_len=seed_len,
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

    axts = []
    for job in jobs:
        t_codes = t_genome.codes(job.t_name, "+")
        q_codes = q_genome.codes(job.q_name, job.q_strand)
        q_size = q_genome.seq(job.q_name).size
        t_lo, t_hi = job.t_block_end - 1, job.t_gap_end
        q_plus_lo, q_plus_hi = job.q_block_end - 1, job.q_gap_end
        if job.q_strand == "-":
            q_lo, q_hi = q_size - q_plus_hi, q_size - q_plus_lo
        else:
            q_lo, q_hi = q_plus_lo, q_plus_hi
        t_seed = (None if unmask else
                  seed_codes(t_genome, t_mask_genome, job.t_name, "+"))
        q_seed = (None if unmask else
                  seed_codes(q_genome, q_mask_genome, job.q_name,
                             job.q_strand))
        hsps = aligner.align(t_codes, q_codes, t_lo, t_hi, q_lo, q_hi,
                             t_seed_codes=t_seed, q_seed_codes=q_seed)
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
    close = isinstance(out_psl, str)
    f = open(out_psl, "w") if close else out_psl
    try:
        write_psls(psls, f)
    finally:
        if close:
            f.close()


def filter_chains_net_filter_nets(
        in_chain: str, in_net: str, out_filtered_chain: str,
        out_filtered_net, t_2bit: str, q_2bit: str,
        t_sizes_file: str, q_sizes_file: str,
        min_scores: list[int], min_t_sizes: list[int],
        min_q_sizes: list[int],
        keep_syn_nets_with_score: int = INT_MAX,
        keep_inv_nets_with_score: int = INT_MAX,
        work_dir: str | None = None,
        device: str | torch.device | None = None) -> None:
    """FilterChains_Net_FilterNets.perl in-process (drivers.py:348-416),
    with chainNet -rescore on `device`.

    chainFilter per (score, tSize, qSize) set (each excluding chrM) ->
    optional syn/inv chain rescue from the input net -> chainSort ->
    chainPreNet -> chainNet -minSpace=1 -rescore -> netSyntenic ->
    NetFilterNonNested.  work_dir: every stage checkpoints its output there
    and an interrupted run resumes at the first incomplete stage."""
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
              linear_gap="loose",
              scorer_factory=torch_scorer_factory(device))
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
        keep_syn, keep_inv, work_dir, device) -> None:
    """Stage-checkpointed variant (drivers.py:419-474; utils/pipeline.py)."""
    from genomealignmenttools_tpu.utils.pipeline import Pipeline
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
                      scorer_factory=torch_scorer_factory(device))
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
