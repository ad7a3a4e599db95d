"""scoreChain engine: exact (re)scoring of every chain in a file.

Behavioral reference: src/scoreChain/scoreChain.c (main:231-345, output
modes at flags 42-50).  Output is byte-identical to the C tool.
"""

from __future__ import annotations

import sys

from ..device.genome import open_genome
from ..formats.chain import format_score, iter_chains
from ..formats.gapcalc import gap_calc_from_file
from ..formats.scorematrix import read_score_scheme, score_scheme_default
from .scoring import ChainScorer


def score_chain_file(
    in_chain: str,
    t_2bit: str,
    q_2bit: str,
    out_path: str,
    linear_gap: str,
    score_scheme: str | None = None,
    do_local_score: bool = False,
    force_local_score: bool = False,
    return_only_score: bool = False,
    return_only_score_and_coords: bool = False,
    scorer_factory=None,
    num_shards: int = 1,
    shard: int = 0,
    device=None,
) -> None:
    """Score every chain in in_chain and write out_path.

    scorer_factory optionally overrides ChainScorer construction; without
    one the chains are scored by the torch scorer on `device` (cuda unless
    named, which raises without CUDA; ops/rescore.py).

    num_shards/shard: deterministic contiguous work partition for
    multi-host fan-out (parallel/distributed.py); concatenating the shard
    outputs in shard order is byte-identical to a single-shard run."""
    if return_only_score and return_only_score_and_coords:
        raise ValueError("cannot set both returnOnlyScore and returnOnlyScoreAndCoords")

    scheme = read_score_scheme(score_scheme) if score_scheme else score_scheme_default()
    gap_calc = gap_calc_from_file(linear_gap)
    t_genome = open_genome(t_2bit)
    q_genome = open_genome(q_2bit)
    if scorer_factory is None:
        # the device is the caller's, never guessed (ops/rescore.py)
        from ..ops.rescore import torch_scorer_factory
        scorer_factory = torch_scorer_factory(device)
    factory = scorer_factory or ChainScorer
    scorer = factory(scheme, gap_calc, t_genome, q_genome)

    from ..utils.profiling import phase

    # overlap the 2bit decode (+ '-'-strand revcomp) with chain parsing:
    # scoring only touches code arrays after the parse.  Benign race:
    # Genome caches per chrom, a concurrent first access at worst decodes
    # twice.
    import threading

    def _prefetch_codes():
        try:
            for seq in t_genome.names():
                t_genome.codes(seq, "+")
            for seq in q_genome.names():
                q_genome.codes(seq, "+")
        except Exception:
            pass  # scoring will surface any real error

    prefetch = threading.Thread(target=_prefetch_codes, daemon=True)
    prefetch.start()

    table = None
    with phase("read chains"):
        if isinstance(in_chain, str):
            # SoA fast path: score + rewrite the whole file from ChainTable
            # columns, no python Chain objects
            from ..native.chain_io import parse_chain_table
            try:
                if in_chain.endswith(".gz"):
                    import gzip as _gz
                    with _gz.open(in_chain, "rb") as fh:
                        _data = fh.read()
                else:
                    with open(in_chain, "rb") as fh:
                        _data = fh.read()
                table = parse_chain_table(_data)
                del _data
            except OSError:
                table = None
            if table is None:
                from ..formats.chain import read_chains
                chains = read_chains(in_chain)  # native codec
        else:
            chains = list(iter_chains(in_chain))
    if num_shards > 1:
        from ..parallel.distributed import shard_indices
        if table is not None:
            idx = shard_indices(len(table), num_shards, shard)
            table = table.row_slice(idx.start, idx.stop)
        else:
            idx = shard_indices(len(chains), num_shards, shard)
            chains = chains[idx.start:idx.stop]
    res = None
    with phase("score chains"):
        if table is not None and hasattr(scorer, "score_table"):
            res = scorer.score_table(table)  # (n,3) or None
        if table is not None and res is None:
            chains = [table.materialize(i) for i in range(len(table))]
            table = None
        if table is None:
            if hasattr(scorer, "score_chains"):
                scored = scorer.score_chains(chains)
            else:
                scored = [scorer.global_and_local(c) for c in chains]

    out = sys.stdout if out_path == "stdout" else open(out_path, "w")
    try:
        if table is not None:
            import numpy as np
            g, loc, ali = res[:, 0], res[:, 1], res[:, 2]
            if return_only_score or return_only_score_and_coords:
                ids = table.ids
                h = table.header
                parts = []
                for i in range(len(table)):
                    if return_only_score:
                        parts.append(
                            f"{int(ids[i])}\t{format_score(g[i])}\t"
                            f"{format_score(loc[i])}\t{int(ali[i])}\n")
                    else:
                        parts.append(
                            f"{int(ids[i])}\t{int(h[i, 1])}\t{int(h[i, 2])}"
                            f"\t{format_score(g[i])}\t{format_score(loc[i])}"
                            f"\t{int(ali[i])}\n")
                out.write("".join(parts))
            else:
                if force_local_score:
                    table.scores = loc.copy()
                else:
                    scores = g.copy()
                    if do_local_score:
                        scores = np.where(g <= 0, loc, g)
                    table.scores = scores
                mv = table.serialize()
                buf = getattr(out, "buffer", None)
                if buf is not None:
                    out.flush()
                    buf.write(mv)
                else:
                    out.write(bytes(mv).decode())
            return
        for chain, (global_score, local_score, ali_bases) in zip(chains,
                                                                 scored):
            if force_local_score:
                chain.score = local_score
            else:
                chain.score = global_score
                if chain.score <= 0 and do_local_score:
                    chain.score = local_score

            if return_only_score:
                out.write(f"{chain.id}\t{format_score(global_score)}\t"
                          f"{format_score(local_score)}\t{ali_bases}\n")
            elif return_only_score_and_coords:
                out.write(f"{chain.id}\t{chain.t_start}\t{chain.t_end}\t"
                          f"{format_score(global_score)}\t"
                          f"{format_score(local_score)}\t{ali_bases}\n")
        if not (return_only_score or return_only_score_and_coords):
            from ..formats.chain import write_chains
            write_chains(chains, out)  # native chainWrite-exact serializer
    finally:
        if out is not sys.stdout:
            out.close()
