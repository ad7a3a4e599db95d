"""Multi-process chainCleaner with the port's scorer.

Counterpart of clean_chains_distributed in
genomealignmenttools_tpu/engines/chain_cleaner.py (chain_cleaner.py:
1842-1875), which reads its rank from jax.  `clean_chains_distributed` is a
copy with three changes: the rank and world size come from torch.distributed
(parallel/distributed.world), clean_chains scores with
torch_scorer_factory(device), and the bundles travel through the port's
host0_merge_text.  The cleaner itself and merge_cleaner_shards are the
reference's own.
"""

from __future__ import annotations

import os

import torch

from genomealignmenttools_tpu.engines.chain_cleaner import (
    clean_chains, merge_cleaner_shards)

from ..ops.rescore import torch_scorer_factory
from ..parallel.distributed import host0_merge_text, world


def clean_chains_distributed(in_chain: str, t_2bit: str, q_2bit: str,
                             out_chain_path: str, out_bed_path: str,
                             work_dir: str, max_gather_bytes: int = 1 << 29,
                             device: str | torch.device | None = None,
                             **kw) -> None:
    """Every rank cleans its shard of the break-list components on
    `device`; the bundles are gathered to every rank and rank 0 merges
    them into out_chain_path and out_bed_path.  One process writes them
    directly.  `kw` goes to clean_chains (thresholds, sizes, linear_gap)."""
    n, me = world()
    os.makedirs(work_dir, exist_ok=True)
    shard_path = os.path.join(work_dir, f"cleaner_shard_{me}.json")
    clean_chains(in_chain, t_2bit, q_2bit, out_chain_path, out_bed_path,
                 num_shards=n, shard=me, shard_out=shard_path,
                 scorer_factory=torch_scorer_factory(device), **kw)
    if n == 1:
        return
    # gather bundles (length-prefixed) to every rank; 0 writes.  The buffer
    # cap must cover shard 0's bundle, which embeds the pass-through chain
    # text.
    with open(shard_path) as f:
        merged = host0_merge_text(f.read() + "\x00",
                                  max_bytes=max_gather_bytes)
    if me == 0:
        paths = []
        for i, text in enumerate(p for p in merged.split("\x00") if p):
            pth = os.path.join(work_dir, f"gathered_{i}.json")
            with open(pth, "w") as f:
                f.write(text)
            paths.append(pth)
        merge_cleaner_shards(paths, out_chain_path, out_bed_path)
