"""The port's sharded scorers and multi-device dry run on CPU device lists.

ShardedBlockScorer, ShardedPairScorer and ShardedChainScorer of
genomealignmenttools_tpu_torch/parallel/mesh.py over ["cpu"] * n, n = 1, 2
and 8, against the JAX package's sharded scorers on make_mesh(n) (8
virtual CPU devices, tests/conftest.py) and the host ChainScorer, mirroring
tests/test_parallel.py.  Every output is an integer or a float made from
one; every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from genomealignmenttools_tpu.device.genome import Genome
from genomealignmenttools_tpu.engines.scoring import ChainScorer
from genomealignmenttools_tpu.formats.chain import read_chains
from genomealignmenttools_tpu.formats.gapcalc import gap_calc_default
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.parallel import mesh as jax_mesh
from genomealignmenttools_tpu_torch.parallel import mesh as pm
from genomealignmenttools_tpu_torch.parallel.dryrun import dryrun_multidevice

N_DEV = [1, 2, 8]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one intra-op thread, so that the parallel test
    runner's workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(fix):
    t_genome = Genome(os.path.join(fix, "target.2bit"))
    q_genome = Genome(os.path.join(fix, "query.2bit"))
    chains = read_chains(os.path.join(fix, "synthetic.chain"))
    return t_genome, q_genome, chains


def _group(chains, strand):
    return [c for c in chains if c.t_name == "chrA" and c.q_name == "chrQ1"
            and c.q_strand == strand]


@pytest.mark.parametrize("n_dev", N_DEV)
def test_sharded_block_scorer_matches_jax_and_host(fixtures_dir, n_dev):
    scheme = score_scheme_default()
    t_genome, q_genome, chains = _inputs(fixtures_dir)
    chains = _group(chains, "+")
    host = ChainScorer(scheme, gap_calc_default(), t_genome, q_genome)
    blocks = np.concatenate([c.blocks for c in chains])
    expected = np.concatenate([host.score_arrays(c)[0] for c in chains])
    args = (t_genome.codes("chrA"), q_genome.codes("chrQ1"), blocks)
    lut = np.asarray(scheme.lut)
    ref = jax_mesh.ShardedBlockScorer(
        lut, jax_mesh.make_mesh(n_dev)).block_scores(*args)
    got = pm.ShardedBlockScorer(lut, ["cpu"] * n_dev).block_scores(*args)
    assert got.dtype == np.int64
    assert np.array_equal(got, expected)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n_dev", N_DEV)
def test_sharded_pair_scorer_matches_jax_and_host(fixtures_dir, n_dev):
    """Same chunks, same chunk scores: the port's score tiles against the
    reference's combined-code tiles (pack_pairs, GAT_PAIR_CHUNK default)."""
    from genomealignmenttools_tpu.ops.pair_rescore import pack_pairs
    scheme = score_scheme_default()
    t_genome, q_genome, chains = _inputs(fixtures_dir)
    chains = _group(chains, "-")
    host = ChainScorer(scheme, gap_calc_default(), t_genome, q_genome)
    blocks = np.concatenate([c.blocks for c in chains])
    expected = np.concatenate([host.score_arrays(c)[0] for c in chains])
    t_codes, q_codes = t_genome.codes("chrA", "+"), q_genome.codes("chrQ1",
                                                                   "-")
    lut = np.asarray(scheme.lut)
    c8, c_block_ref, m_ref = pack_pairs(t_codes, q_codes, blocks)
    ref = jax_mesh.ShardedPairScorer(
        lut, jax_mesh.make_mesh(n_dev)).chunk_scores(c8)[:m_ref]
    scorer = pm.ShardedPairScorer(lut, ["cpu"] * n_dev)
    tiles, c_block, m = scorer.pack(t_codes, q_codes, blocks)
    cs = scorer.chunk_scores(tiles)
    assert m == m_ref and np.array_equal(c_block, c_block_ref)
    assert cs.dtype == np.int32 and np.array_equal(cs, ref.astype(np.int32))
    got = np.zeros(blocks.shape[0], np.int64)
    np.add.at(got, c_block, cs.astype(np.int64))
    assert np.array_equal(got, expected)


@pytest.mark.parametrize("n_dev", N_DEV)
def test_sharded_chain_scorer_matches_jax_and_host(fixtures_dir, n_dev):
    scheme, gc = score_scheme_default(), gap_calc_default()
    t_genome, q_genome, chains = _inputs(fixtures_dir)
    want = [ChainScorer(scheme, gc, t_genome, q_genome).global_and_local(c)
            for c in chains]
    ref = jax_mesh.ShardedChainScorer(
        scheme, gc, t_genome, q_genome,
        jax_mesh.make_mesh(n_dev)).score_chains(chains)
    scorer = pm.ShardedChainScorer(scheme, gc, t_genome, q_genome,
                                   ["cpu"] * n_dev)
    got = scorer.score_chains(chains)
    assert got == want
    assert got == ref
    cuts = scorer.cuts(chains)
    assert cuts[0] == 0 and cuts[-1] == len(chains) and len(cuts) == n_dev + 1
    assert all(a <= b for a, b in zip(cuts, cuts[1:]))


def test_chain_longer_than_a_shard_and_empty_shards(fixtures_dir):
    """One chain holds most of the chunks: it gets a shard of its own, a
    shard whose share lies inside it stays empty, and the scores stay
    exact."""
    scheme, gc = score_scheme_default(), gap_calc_default()
    t_genome, q_genome, chains = _inputs(fixtures_dir)
    by_size = sorted(chains, key=lambda c: c.n_blocks)
    long_chain = by_size[-1]
    chains = [by_size[0], long_chain, by_size[1], by_size[2]]
    scorer = pm.ShardedChainScorer(scheme, gc, t_genome, q_genome,
                                   ["cpu"] * 4)
    cuts = scorer.cuts(chains)
    sizes = [b - a for a, b in zip(cuts, cuts[1:])]
    assert [1] == [b - a for a, b in zip(cuts, cuts[1:])
                   if a <= 1 < b], cuts              # the long chain alone
    assert 0 in sizes, cuts
    host = ChainScorer(scheme, gc, t_genome, q_genome)
    assert scorer.score_chains(chains) == [host.global_and_local(c)
                                           for c in chains]


def test_chain_cuts_nearest_start():
    assert pm.chain_cuts([1, 100, 1, 1], 4) == [0, 1, 2, 2, 4]
    assert pm.chain_cuts([5, 5, 5, 5], 2) == [0, 2, 4]
    assert pm.chain_cuts([5, 5, 5, 5], 1) == [0, 4]
    assert pm.chain_cuts([], 3) == [0, 0, 0, 0]
    assert pm.chain_cuts([2, 2], 4) == [0, 0, 1, 1, 2]


def test_more_shards_than_chains(fixtures_dir):
    scheme, gc = score_scheme_default(), gap_calc_default()
    t_genome, q_genome, chains = _inputs(fixtures_dir)
    chains = chains[:3]
    scorer = pm.ShardedChainScorer(scheme, gc, t_genome, q_genome,
                                   ["cpu"] * 8)
    assert sum(b > a for a, b in zip(scorer.cuts(chains),
                                     scorer.cuts(chains)[1:])) <= 3
    host = ChainScorer(scheme, gc, t_genome, q_genome)
    assert scorer.score_chains(chains) == [host.global_and_local(c)
                                           for c in chains]
    assert scorer.score_chains([]) == []


def test_make_mesh(monkeypatch):
    assert pm.make_mesh(devices=["cpu"] * 8) == (torch.device("cpu"),) * 8
    assert pm.make_mesh(3, ["cpu"] * 8) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        pm.make_mesh(devices=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.make_mesh(devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.ShardedChainScorer(score_scheme_default(), gap_calc_default(),
                              None, None)


def test_dryrun_multidevice_cpu():
    dryrun_multidevice(["cpu"] * 2)
