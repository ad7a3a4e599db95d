"""TorchChainScorer (the port's ops/rescore.py) against the JAX reference.

TorchChainScorer(device="cpu") must give exactly what DeviceChainScorer in
its `pallas` mode (interpret mode here) and the host ChainScorer give, through
score_chains, score_table and global_and_local, on tests/fixtures/
synthetic.chain and on a seeded random chain set on both strands.
"""

import os

import numpy as np
import pytest
import torch

from genomealignmenttools_tpu.device.genome import Genome
from genomealignmenttools_tpu.engines.scoring import ChainScorer
from genomealignmenttools_tpu.formats.chain import Chain, read_chains
from genomealignmenttools_tpu.formats.gapcalc import (gap_calc_default,
                                                      gap_calc_from_file)
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.native.chain_io import parse_chain_table
from genomealignmenttools_tpu.ops import pallas_rescore
from genomealignmenttools_tpu.ops.rescore import DeviceChainScorer
from genomealignmenttools_tpu_torch import device as port_device
from genomealignmenttools_tpu_torch.ops import rescore as port_rescore
from genomealignmenttools_tpu_torch.ops.rescore import (TorchChainScorer,
                                                        TorchGenomeCache,
                                                        torch_scorer_factory)


@pytest.fixture(scope="module")
def setup(fixtures_dir):
    scheme = score_scheme_default()
    gc = gap_calc_from_file("loose")
    t_genome = Genome(os.path.join(fixtures_dir, "target.2bit"))
    q_genome = Genome(os.path.join(fixtures_dir, "query.2bit"))
    return scheme, gc, t_genome, q_genome


def _random_chains(seed=11, n=40):
    """Adversarial chains (as tests/test_device_rescore.py builds them):
    negative runs, multi-chunk blocks, both strands."""
    rng = np.random.default_rng(seed)
    chains = []
    for ci in range(n):
        nb = int(rng.integers(1, 12))
        t = int(rng.integers(0, 800_000))
        q = int(rng.integers(0, 1_700_000))
        rows = []
        for _ in range(nb):
            ln = int(rng.integers(1, 600))
            rows.append((t, t + ln, q, q + ln))
            t += ln + int(rng.integers(0, 3000))
            q += ln + int(rng.integers(0, 3000))
        blocks = np.array(rows, np.int64)
        chains.append(Chain(
            score=0.0, t_name="chrA", t_size=1_000_000,
            t_start=int(blocks[0, 0]), t_end=int(blocks[-1, 1]),
            q_name="chrQ1", q_size=2_000_000,
            q_strand="+" if ci % 2 else "-",
            q_start=int(blocks[0, 2]), q_end=int(blocks[-1, 3]),
            id=ci + 1, blocks=blocks))
    return chains


@pytest.fixture(scope="module")
def chain_sets(fixtures_dir):
    return {"synthetic": read_chains(os.path.join(fixtures_dir,
                                                  "synthetic.chain")),
            "random": _random_chains()}


@pytest.fixture(scope="module")
def pallas_scores(setup, chain_sets):
    """The reference's pallas mode on both chain sets (interpret mode)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_rescore, "WB", 16)
    try:
        dev = DeviceChainScorer(*setup, mode="pallas")
        return {k: dev.score_chains(v) for k, v in chain_sets.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("which", ["synthetic", "random"])
def test_score_chains_matches_pallas_and_host(setup, chain_sets,
                                              pallas_scores, which):
    chains = chain_sets[which]
    port = TorchChainScorer(*setup, device="cpu")
    got = port.score_chains(chains)
    assert got == pallas_scores[which]
    host = ChainScorer(*setup)
    assert got == [host.global_and_local(c) for c in chains]


@pytest.mark.parametrize("which", ["synthetic", "random"])
def test_global_and_local_matches_host(setup, chain_sets, which):
    port = TorchChainScorer(*setup, device="cpu")
    host = ChainScorer(*setup)
    for chain in chain_sets[which][:15]:
        assert port.global_and_local(chain) == host.global_and_local(chain)
        assert port.global_score(chain) == host.global_score(chain)
        bs_p, gc_p = port.score_arrays(chain)
        bs_h, gc_h = host.score_arrays(chain)
        assert np.array_equal(bs_p, bs_h) and np.array_equal(gc_p, gc_h)


def test_score_table_matches_pallas_and_host(setup, fixtures_dir,
                                             pallas_scores, chain_sets):
    with open(os.path.join(fixtures_dir, "synthetic.chain"), "rb") as f:
        table = parse_chain_table(f.read())
    port = TorchChainScorer(*setup, device="cpu")
    got = port.score_table(table)
    assert got.shape == (len(table), 3)
    want = np.array(pallas_scores["synthetic"], np.float64)
    assert np.array_equal(got, want)
    host = ChainScorer(*setup)
    assert np.array_equal(got, np.array(
        [host.global_and_local(c) for c in chain_sets["synthetic"]]))


def test_score_chains_without_native_library(setup, chain_sets, monkeypatch):
    """GAT_NATIVE=0: numpy combine in score_chains, score_table declines."""
    import genomealignmenttools_tpu_torch.native as nat
    monkeypatch.setenv("GAT_NATIVE", "0")
    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_lib", None)
    port = TorchChainScorer(*setup, device="cpu")
    chains = chain_sets["random"][:20]
    host = ChainScorer(*setup)
    assert port.score_chains(chains) == [host.global_and_local(c)
                                         for c in chains]
    assert port.score_table(object()) is None
    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_lib", None)


def test_score_chains_empty_and_mixed_groups(setup, chain_sets):
    port = TorchChainScorer(*setup, device="cpu")
    assert port.score_chains([]) == []
    chains = chain_sets["synthetic"][:3] + chain_sets["random"][:3]
    jobs, order = port._grouped(chains)
    assert sorted(order) == list(range(len(chains)))
    assert sum(b.shape[0] for *_, b in jobs) == sum(c.n_blocks
                                                   for c in chains)
    host = ChainScorer(*setup)
    assert port.score_chains(chains) == [host.global_and_local(c)
                                         for c in chains]


def test_scorer_dev_is_not_host_native(setup):
    """chainCleaner / chainNet take the batched score_chains path only for
    a `_dev` that is not host-native (chain_cleaner.py:709-713)."""
    port = TorchChainScorer(*setup, device="cpu")
    assert port._dev is not None
    assert getattr(port._dev, "host_native", True) is False


def test_device_is_explicit(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchChainScorer(*setup)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_scorer_factory("cuda")
    with pytest.raises(ValueError):
        port_device.resolve_device("meta")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_genome_cache_uploads_once_and_evicts_fifo(setup, monkeypatch):
    monkeypatch.setattr(port_rescore, "_DEV_CODES", {})
    _, _, t_genome, q_genome = setup
    cpu = torch.device("cpu")
    cache = TorchGenomeCache(t_genome, cpu)
    a = cache.codes("chrA", "+")
    assert a.dtype == torch.uint8 and a.device == cpu
    assert cache.codes("chrA", "+") is a
    assert np.array_equal(a.numpy(), t_genome.codes("chrA", "+"))
    monkeypatch.setattr(port_rescore, "DEV_CODES_BUDGET",
                        q_genome.codes("chrQ1", "+").nbytes)
    small = TorchGenomeCache(q_genome, cpu)
    small.codes("chrQ1", "+")
    small.codes("chrQ2", "+")   # evicts the oldest entries to fit
    assert len(port_rescore._DEV_CODES) == 1


def test_torch_scorer_factory_builds_cpu_scorer(setup):
    scorer = torch_scorer_factory("cpu")(*setup)
    assert isinstance(scorer, TorchChainScorer)
    assert scorer.device == torch.device("cpu")
    assert scorer.global_and_local(_random_chains(n=1)[0]) == \
        ChainScorer(*setup).global_and_local(_random_chains(n=1)[0])


def test_gap_calc_default_scores_match(setup, chain_sets):
    scheme, _, t_genome, q_genome = setup
    gc = gap_calc_default()
    port = TorchChainScorer(scheme, gc, t_genome, q_genome, device="cpu")
    host = ChainScorer(scheme, gc, t_genome, q_genome)
    chains = chain_sets["random"]
    assert port.score_chains(chains) == [host.global_and_local(c)
                                         for c in chains]


class _Arrays:
    """A genome whose codes(name, strand) is a fixed numpy array a name."""

    def __init__(self, arrays):
        self.arrays = arrays

    def codes(self, name, strand):
        return self.arrays[name]


def test_dev_codes_eviction_order_is_the_reference_s(monkeypatch):
    """The same sequence of host arrays through the port's TorchGenomeCache
    and through the reference's _dev_codes_entry/_dev_codes_store (its
    dict logic needs no jax array: any object stands for the device copy)
    leaves the same arrays resident, in the same order, after every step.
    The budget is set on both modules' attributes with monkeypatch: the
    port's is the constant DEV_CODES_BUDGET, the reference's is read from
    GAT_DEV_CODES_BUDGET once, at import."""
    from genomealignmenttools_tpu.ops import rescore as ref_rescore
    rng = np.random.default_rng(5)
    sizes = {"a": 300, "b": 500, "c": 200, "d": 700, "e": 100}
    arrays = {k: rng.integers(0, 5, n).astype(np.uint8)
              for k, n in sizes.items()}
    budget = 1000
    monkeypatch.setattr(port_rescore, "_DEV_CODES", {})
    monkeypatch.setattr(port_rescore, "DEV_CODES_BUDGET", budget)
    monkeypatch.setattr(ref_rescore, "_DEV_CODES", {})
    monkeypatch.setattr(ref_rescore, "_DEV_CODES_BUDGET", budget)
    cache = TorchGenomeCache(_Arrays(arrays), torch.device("cpu"))
    uploads = {}
    for name in "abacdbeeadcab":
        codes = arrays[name]
        h2d = port_device.PERF["h2d_bytes"]
        before = port_rescore._DEV_CODES.get((id(codes), "cpu"))
        got = cache.codes(name, "+")
        assert np.array_equal(got.numpy(), codes)
        if before is not None:   # a hit re-uploads nothing
            assert got is before[1]
            assert port_device.PERF["h2d_bytes"] == h2d
        uploads[name] = uploads.get(name, 0) + (before is None)
        if ref_rescore._dev_codes_entry(codes, 0, "u8") is None:
            ref_rescore._dev_codes_store(codes, 0, "u8", object())
        port_order = [e[0] for e in port_rescore._DEV_CODES.values()]
        ref_order = [e[0] for e in ref_rescore._DEV_CODES.values()]
        assert [id(a) for a in port_order] == [id(a) for a in ref_order]
        assert sum(a.nbytes for a in port_order) <= budget
    assert sum(uploads.values()) < len("abacdbeeadcab")


def test_dev_codes_budget_of_one_genome_evicts_the_first(setup,
                                                         monkeypatch):
    """With a budget of one genome's bytes, the second genome's codes evict
    the first's; asking for the first again uploads it again."""
    _, _, t_genome, q_genome = setup
    first = q_genome.codes("chrQ1", "+")
    second = t_genome.codes("chrA", "+")
    assert second.nbytes <= first.nbytes
    monkeypatch.setattr(port_rescore, "_DEV_CODES", {})
    monkeypatch.setattr(port_rescore, "DEV_CODES_BUDGET", first.nbytes)
    cpu = torch.device("cpu")
    a = TorchGenomeCache(q_genome, cpu).codes("chrQ1", "+")
    assert TorchGenomeCache(q_genome, cpu).codes("chrQ1", "+") is a
    TorchGenomeCache(t_genome, cpu).codes("chrA", "+")
    assert [e[0] for e in port_rescore._DEV_CODES.values()] == [second]
    again = TorchGenomeCache(q_genome, cpu).codes("chrQ1", "+")
    assert again is not a and torch.equal(again, a)
    assert [e[0] for e in port_rescore._DEV_CODES.values()] == [first]
