"""patchChain with the port's gap aligner.

Counterpart of patch_chain in genomealignmenttools_tpu/engines/drivers.py.
The reference builds its GapAligner itself (drivers.py:224), so `patch_chain`
is a copy of drivers.py:181-289 with one change: the aligner is a
TorchGapAligner on `device` (K3 on CUDA, its plain version on the CPU).  As
in the reference, each gap runs its own align() and with it one band batch.
The gap walk, the axt entry filter, the axt-to-psl conversion and the psl
writer are the reference's own.
"""

from __future__ import annotations

import torch

from genomealignmenttools_tpu.device.genome import Genome
from genomealignmenttools_tpu.engines.chain_tools import _CharGenome
from genomealignmenttools_tpu.engines.converters import axt_to_psl_records
from genomealignmenttools_tpu.engines.drivers import _check_axt_entry
from genomealignmenttools_tpu.engines.repeat_filler import harvest_gap_jobs
from genomealignmenttools_tpu.formats.axt import Axt
from genomealignmenttools_tpu.formats.chromsizes import read_chrom_sizes
from genomealignmenttools_tpu.formats.psl import write_psls
from genomealignmenttools_tpu.formats.scorematrix import (
    read_score_scheme, score_scheme_default)

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
