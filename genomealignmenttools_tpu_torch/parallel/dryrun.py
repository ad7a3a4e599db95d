"""Multi-device dry run of the port: every sharded path once, on tiny shapes.

Counterpart of dryrun_multichip and _dryrun_pallas_under_mesh in the repo's
__graft_entry__.py (:40-349).  On the given devices (repeats allowed:
["cuda:0"] * 4 on one card, ["cpu"] * 2 in the tests) it runs

1. ShardedBlockScorer and ShardedPairScorer against numpy, and
   ShardedChainScorer against the host ChainScorer, on seeded genomes;
2. on the fixtures, through the port's scorer with shard i on device i:
   chainCleaner in shards merged by merge_cleaner_shards, chainNet -rescore
   in two per-chromosome shards, and the port's RepeatFiller in two chain
   shards, each byte-identical to the unsharded run;
3. band-DP problems split across the devices against the unsplit batch
   (meta and moves exactly; K3 on CUDA), and the whole batch through
   BandExtBatch against numpy band_ext: the analog of the shard_map band
   check.

Any difference raises RuntimeError.
"""

from __future__ import annotations

import io
import os
import tempfile

import numpy as np
import torch

from ..engines.chain_cleaner import clean_chains, merge_cleaner_shards
from ..engines.chain_net import chain_net
from ..engines.repeat_filler import repeat_filler
from ..engines.scoring import ChainScorer
from ..formats.chain import Chain
from ..formats.gapcalc import gap_calc_default
from ..formats.scorematrix import score_scheme_default
from ..ops import band_batch as bb
from ..ops.band_ext import band_ext
from ..ops.pair_rescore import pack_pairs
from ..ops.rescore import torch_scorer_factory
from ..utils.verbose import set_verbosity, verbosity
from .distributed import shard_indices
from .mesh import (ShardedBlockScorer, ShardedChainScorer, ShardedPairScorer,
                   make_mesh)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multidevice: {msg}")


class _ArrayGenome:
    """A genome of one sequence given as codes (both strands)."""

    def __init__(self, codes: np.ndarray):
        self._codes = codes

    def codes(self, name: str, strand: str = "+") -> np.ndarray:
        if strand == "-":
            return np.array([3, 2, 1, 0, 4], np.uint8)[self._codes[::-1]]
        return self._codes


def _scorers(mesh, rng) -> None:
    genome_size = 1 << 14
    t_codes = rng.integers(0, 5, genome_size, dtype=np.uint8)
    q_codes = rng.integers(0, 5, genome_size, dtype=np.uint8)
    lut = np.zeros((5, 5), np.int32)          # N row and column score 0
    lut[:4, :4] = rng.integers(-125, 100, (4, 4))
    n_blocks = 64 * len(mesh)
    starts = np.sort(rng.integers(0, genome_size - 64,
                                  n_blocks)).astype(np.int64)
    blocks = np.stack([starts, starts + 32, starts, starts + 32], axis=1)
    lane = np.arange(32)
    ref = lut[q_codes[blocks[:, 2, None] + lane],
              t_codes[blocks[:, 0, None] + lane]].sum(1)

    got = ShardedBlockScorer(lut, mesh).block_scores(t_codes, q_codes, blocks)
    _check(got.shape == (n_blocks,) and np.array_equal(got, ref),
           "ShardedBlockScorer != numpy")
    pair = ShardedPairScorer(lut, mesh)
    tiles, c_block, m = pack_pairs(t_codes, q_codes, blocks)
    got = np.zeros(n_blocks, np.int64)
    np.add.at(got, c_block, pair.chunk_scores(tiles)[:m].astype(np.int64))
    _check(np.array_equal(got, ref), "ShardedPairScorer != numpy")

    chains = []
    # sizes and gaps small enough that every chain ends inside the genome
    for ci in range(8):
        t0 = ci * (genome_size // 8) + 64
        sizes = rng.integers(8, 40, 24)
        ts = t0 + np.concatenate([[0], np.cumsum(
            sizes[:-1] + rng.integers(0, 30, 23))])
        qs = t0 + np.concatenate([[0], np.cumsum(
            sizes[:-1] + rng.integers(0, 30, 23))])
        b = np.stack([ts, ts + sizes, qs, qs + sizes], 1).astype(np.int64)
        chains.append(Chain(
            score=0.0, t_name="chrT", t_size=genome_size,
            t_start=int(b[0, 0]), t_end=int(b[-1, 1]), q_name="chrQ",
            q_size=genome_size, q_strand="+" if ci % 3 else "-",
            q_start=int(b[0, 2]), q_end=int(b[-1, 3]), id=ci + 1, blocks=b))
    scheme, gc = score_scheme_default(), gap_calc_default()
    tg, qg = _ArrayGenome(t_codes), _ArrayGenome(q_codes)
    want = [ChainScorer(scheme, gc, tg, qg).global_and_local(c)
            for c in chains]
    got = ShardedChainScorer(scheme, gc, tg, qg, mesh).score_chains(chains)
    _check(got == want, "ShardedChainScorer != host ChainScorer")


def _engines(mesh, fx: str, td: str) -> None:
    f = lambda n: os.path.join(fx, n)  # noqa: E731
    o = lambda n: os.path.join(td, n)  # noqa: E731
    factory = lambda i: torch_scorer_factory(mesh[i % len(mesh)])  # noqa
    chain_in = f("synthetic.scored.sorted.chain")
    t2, q2 = f("target.2bit"), f("query.2bit")
    t_sz, q_sz = f("target.chrom.sizes"), f("query.chrom.sizes")

    common = dict(t_sizes=t_sz, q_sizes=q_sz, linear_gap="loose")
    clean_chains(chain_in, t2, q2, o("single.chain"), o("single.bed"),
                 scorer_factory=factory(0), **common)
    n_shards = min(len(mesh), 4)
    paths = [o(f"shard{sh}.json") for sh in range(n_shards)]
    for sh, pth in enumerate(paths):
        clean_chains(chain_in, t2, q2, o("u.chain"), o("u.bed"),
                     num_shards=n_shards, shard=sh, shard_out=pth,
                     scorer_factory=factory(sh), **common)
    merge_cleaner_shards(paths, o("merged.chain"), o("merged.bed"))
    for a, b in (("merged.chain", "single.chain"),
                 ("merged.bed", "single.bed")):
        with open(o(a)) as fa, open(o(b)) as fb:
            _check(fa.read() == fb.read(),
                   f"sharded cleaner {a} != single run")

    t1, q1 = io.StringIO(), io.StringIO()
    chain_net(chain_in, t_sz, q_sz, t1, q1, rescore=True, t_2bit=t2,
              q_2bit=q2, linear_gap="loose", scorer_factory=factory(0))
    t_parts, q_parts = [], []
    for sh in range(2):           # the fixtures have 2 chroms per side
        ts, qs = io.StringIO(), io.StringIO()
        chain_net(chain_in, t_sz, q_sz, ts, qs, rescore=True, t_2bit=t2,
                  q_2bit=q2, linear_gap="loose", num_shards=2, shard=sh,
                  scorer_factory=factory(sh))
        t_parts.append(ts.getvalue())
        q_parts.append(qs.getvalue())
    _check("".join(t_parts) == t1.getvalue()
           and "".join(q_parts) == q1.getvalue(),
           "sharded chainNet -rescore != single run")

    rf_in = f("repeatfiller_input.chain")
    whole = io.StringIO()
    repeat_filler(rf_in, t2, q2, whole, device=mesh[0])
    parts = []
    for sh in range(2):
        p = io.StringIO()
        repeat_filler(rf_in, t2, q2, p, num_shards=2, shard=sh,
                      device=mesh[sh % len(mesh)])
        parts.append(p.getvalue())
    _check("".join(parts) == whole.getvalue(),
           "sharded RepeatFiller != single run")


def _band_split(mesh, rng) -> None:
    scheme = score_scheme_default()
    cm = scheme.char_matrix()
    max_insert = 10
    bases = np.frombuffer(b"ACGT", np.uint8)
    probs = []
    for i in range(4 * len(mesh)):
        a = bases[rng.integers(0, 4, 60 + 10 * (i % 5))].tobytes()
        mut = bytearray(a)
        del mut[30 + (i % 20)]
        probs.append((a, bytes(mut), 1 if i % 2 else -1))
    batch = bb.BandExtBatch(False, cm, scheme.gap_open, scheme.gap_extend,
                            max_insert, a_max=128, device=mesh[0])
    _, todo = bb.orient(probs, batch.a_max)

    def run(part, dev):
        args = [torch.from_numpy(x).to(dev) for x in bb.pack(part)]
        return bb.band_ext_batch(*args, batch.mat, False, batch.gap_open,
                                 batch.gap_extend, max_insert)

    whole = [x.cpu() for x in run(todo, mesh[0])]
    queued = []
    for d, dev in enumerate(mesh):
        r = shard_indices(len(todo), len(mesh), d)
        if len(r):
            queued.append(run(todo[r.start:r.stop], dev))
    # moves are per problem, in problem order: the shards' moves
    # concatenate to the whole batch's
    split = [torch.cat([q[k].cpu() for q in queued]) for k in range(2)]
    _check(torch.equal(split[0], whole[0]) and torch.equal(split[1],
                                                          whole[1]),
           "band DP split across devices != unsplit batch")
    got = batch.run(probs)
    for i, (a, b, direction) in enumerate(probs):
        _check(got[i] == band_ext(False, cm, scheme.gap_open,
                                  scheme.gap_extend, max_insert, a, b,
                                  direction),
               f"BandExtBatch != band_ext at problem {i}")


def dryrun_multidevice(devices, fixtures_dir: str = FIXTURES) -> None:
    """Run the sharded scorers, the sharded engines on the fixtures and the
    split band DP on `devices`; raises RuntimeError on any difference."""
    mesh = make_mesh(devices=devices)
    rng = np.random.default_rng(0)
    _scorers(mesh, rng)
    level = verbosity()
    set_verbosity(0)
    try:
        with tempfile.TemporaryDirectory(prefix="gat_dryrun_") as td:
            _engines(mesh, fixtures_dir, td)
    finally:
        set_verbosity(level)
    _band_split(mesh, rng)
