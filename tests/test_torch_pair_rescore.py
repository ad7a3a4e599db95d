"""Pair mode of the port (ops/pair_rescore.py, TorchChainScorer(mode="pair"))
against the JAX reference.

On tests/fixtures/synthetic.chain (both strands) and a seeded random chain
set: the port's int8-tile chunk sums and block sums equal the JAX
PairBlockScorer's and the host's; TorchPairChainScorer.score and
score_chained equal the JAX PairChainScorer (its staged combine, as it runs
on the CPU) and the host ChainScorer; the int32 guard sends a batch to the
host combine with the same scores; GAT_PAIR_CHUNK, GAT_RESCORE and
GAT_COMBINE are checked.  Integer math: every comparison is exact.
"""

import os

import numpy as np
import pytest

from genomealignmenttools_tpu.device.genome import Genome
from genomealignmenttools_tpu.engines.scoring import ChainScorer, block_scores
from genomealignmenttools_tpu.formats.chain import read_chains
from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops import pair_rescore as jax_pair
from genomealignmenttools_tpu_torch.device import PERF
from genomealignmenttools_tpu_torch.ops import pair_rescore as port_pair
from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
from test_torch_rescore import _random_chains

CPU = "cpu"


@pytest.fixture(scope="module")
def setup(fixtures_dir):
    return (score_scheme_default(), gap_calc_from_file("loose"),
            Genome(os.path.join(fixtures_dir, "target.2bit")),
            Genome(os.path.join(fixtures_dir, "query.2bit")))


@pytest.fixture(scope="module")
def chain_sets(fixtures_dir):
    return {"synthetic": read_chains(os.path.join(fixtures_dir,
                                                  "synthetic.chain")),
            "random": _random_chains()}


def _jobs(setup, chains):
    """(jobs, chain block counts) as TorchChainScorer.score_chains makes
    them; both sides score the same job arrays."""
    port = TorchChainScorer(*setup, device=CPU, mode="pair")
    jobs, order = port._grouped(chains)
    return jobs, [chains[i].n_blocks for i in order], order


@pytest.mark.parametrize("which", ["synthetic", "random"])
def test_block_scores_match_jax_pair_and_host(setup, chain_sets, which):
    scheme, gc, t_genome, q_genome = setup
    jobs, _, _ = _jobs(setup, chain_sets[which])
    assert {strand for (_, _, strand, _) in jobs} == {"+", "-"}
    port = port_pair.TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                          q_genome, CPU)
    ref = jax_pair.PairBlockScorer(np.asarray(scheme.lut), t_genome,
                                   q_genome)
    got = port.block_scores_multi(jobs)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref.block_scores_multi(jobs))
    host = np.concatenate([
        block_scores(b, t_genome.codes(tn, "+"), q_genome.codes(qn, strand),
                     scheme.lut) for (tn, qn, strand, b) in jobs])
    assert np.array_equal(got, host)
    cs, c_block, n_blocks = port.chunk_scores_multi(jobs)
    cs_j, c_block_j, n_blocks_j = ref.chunk_scores_multi(jobs)
    assert cs.dtype == np.int32 and np.array_equal(cs, cs_j)
    assert np.array_equal(c_block, c_block_j) and n_blocks == n_blocks_j
    tn, qn, strand, blocks = jobs[0]
    assert np.array_equal(port.block_scores(tn, qn, strand, blocks),
                          got[:blocks.shape[0]])


@pytest.mark.parametrize("which", ["synthetic", "random"])
def test_chain_scorer_matches_jax_pair_and_host(setup, chain_sets, which):
    scheme, gc, t_genome, q_genome = setup
    chains = chain_sets[which]
    jobs, nblocks, order = _jobs(setup, chains)
    port = port_pair.TorchPairChainScorer(
        port_pair.TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                       q_genome, CPU), gc)
    ref = jax_pair.PairChainScorer(
        jax_pair.PairBlockScorer(np.asarray(scheme.lut), t_genome, q_genome),
        gc)
    got = port.score(jobs, nblocks)
    assert got == ref.score(jobs, nblocks)
    host = ChainScorer(*setup)
    assert got == [host.global_and_local(chains[i]) for i in order]
    chained = port.score_chained(jobs, nblocks, 3)
    assert np.array_equal(chained.astype(np.int64),
                          ref.score_chained(jobs, nblocks, 3))
    assert chained.tolist() == [[g, loc] for (g, loc, _) in got]
    tiles = port.pair._pack(jobs).tiles
    assert port.resident_hbm_bytes(jobs, nblocks) == \
        tiles.numel() + 20 * tiles.shape[0]


def test_pack_and_meta_are_cached_and_padded(setup, chain_sets):
    scheme, gc, t_genome, q_genome = setup
    jobs, nblocks, _ = _jobs(setup, chain_sets["random"])
    pair = port_pair.TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                          q_genome, CPU)
    pcs = port_pair.TorchPairChainScorer(pair, gc)
    pack = pair._pack(jobs)
    assert pair._pack(jobs) is pack
    assert pack.tiles.shape[0] % port_pair.TILE == 0
    assert pack.tiles.shape[1] == port_pair.CHUNK
    assert not pack.tiles[pack.m:].any()
    meta = pcs._meta(jobs, nblocks)
    assert pcs._meta(jobs, nblocks) is meta
    assert not meta.flags[pack.m:].any() and not meta.bias[pack.m:].any()
    # same shapes, new arrays: packed again
    fresh = [(tn, qn, st, b.copy()) for (tn, qn, st, b) in jobs]
    assert pair._pack(fresh) is not pack


def _huge_gap_calc(tmp_path):
    """The loose table with every cost times 10^6: a chain with a few gaps
    passes 2^31, the reach of the device combine's int32 scans."""
    path = tmp_path / "huge.gap"
    pos = "1 2 3 11 111 2111 12111 32111 72111 152111 252111"
    loose = {"qGap": [325, 360, 400, 450, 600, 1100, 3600, 7600, 15600,
                      31600, 56600],
             "bothGap": [625, 660, 700, 750, 900, 1400, 4000, 8000, 16000,
                         32000, 57000]}
    rows = [f"{k} " + " ".join(str(v * 1000000) for v in loose[src])
            for k, src in (("qGap", "qGap"), ("tGap", "qGap"),
                           ("bothGap", "bothGap"))]
    path.write_text("tableSize 11\nsmallSize 111\nposition " + pos + "\n"
                    + "\n".join(rows) + "\n")
    return gap_calc_from_file(str(path))


def test_overflow_takes_host_combine(setup, chain_sets, tmp_path,
                                     monkeypatch):
    scheme, _, t_genome, q_genome = setup
    gc = _huge_gap_calc(tmp_path)
    chains = chain_sets["random"]
    pair = port_pair.TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                          q_genome, CPU)
    jobs, nblocks, _ = _jobs(setup, chains)
    with pytest.raises(OverflowError):
        port_pair.TorchPairChainScorer(pair, gc).score(jobs, nblocks)
    monkeypatch.setenv("GAT_COMBINE", "device")
    port = TorchChainScorer(scheme, gc, t_genome, q_genome, device=CPU,
                            mode="pair")
    before = PERF["combine_overflow"]
    got = port.score_chains(chains)
    assert PERF["combine_overflow"] == before + 1
    host = ChainScorer(scheme, gc, t_genome, q_genome)
    want = [host.global_and_local(c) for c in chains]
    assert got == want
    assert max(-g for (g, _, _) in want) >= 2 ** 31


@pytest.fixture
def combine_calls(monkeypatch):
    """Counts the calls of the combine wrapper from the pair scorer."""
    calls = []
    real = port_pair.pair_combine_scan

    def spy(*args):
        calls.append(args[0].numel())
        return real(*args)
    monkeypatch.setattr(port_pair, "pair_combine_scan", spy)
    return calls


@pytest.mark.parametrize("combine,expect", [
    ("device", [True, True]), ("host", [False, False]),
    ("auto", [False, True])])
def test_score_chains_combine_choice(setup, chain_sets, monkeypatch,
                                     combine_calls, combine, expect):
    """GAT_COMBINE: auto takes the device combine from the second scoring
    of the same chain set on (the memo in _grouped), as the reference."""
    monkeypatch.setenv("GAT_COMBINE", combine)
    chains = chain_sets["synthetic"]
    port = TorchChainScorer(*setup, device=CPU, mode="pair")
    host = [ChainScorer(*setup).global_and_local(c) for c in chains]
    used = []
    for _ in range(2):
        n = len(combine_calls)
        assert port.score_chains(chains) == host
        used.append(len(combine_calls) > n)
    assert used == expect
    assert port._repeat_workload


def test_score_table_and_single_chain_paths(setup, chain_sets, fixtures_dir):
    from genomealignmenttools_tpu.native.chain_io import parse_chain_table
    with open(os.path.join(fixtures_dir, "synthetic.chain"), "rb") as f:
        table = parse_chain_table(f.read())
    port = TorchChainScorer(*setup, device=CPU, mode="pair")
    host = ChainScorer(*setup)
    want = [host.global_and_local(c) for c in chain_sets["synthetic"]]
    assert np.array_equal(port.score_table(table), np.array(want))
    for chain in chain_sets["synthetic"][:5]:
        assert port.global_and_local(chain) == host.global_and_local(chain)
    assert port.score_chains([]) == []


@pytest.mark.parametrize("value", ["127", "0", "-2", "260", "1000", "x"])
def test_bad_pair_chunk_raises(setup, monkeypatch, value):
    monkeypatch.setenv("GAT_PAIR_CHUNK", value)
    with pytest.raises(ValueError, match="GAT_PAIR_CHUNK"):
        TorchChainScorer(*setup, device=CPU, mode="pair")


@pytest.mark.parametrize("value", ["2", "64", "258"])
def test_other_pair_chunks_give_the_same_scores(setup, chain_sets,
                                                monkeypatch, value):
    monkeypatch.setenv("GAT_PAIR_CHUNK", value)
    monkeypatch.setenv("GAT_COMBINE", "device")
    port = TorchChainScorer(*setup, device=CPU, mode="pair")
    assert port._dev.chunk == int(value)
    chains = chain_sets["random"]
    host = ChainScorer(*setup)
    assert port.score_chains(chains) == [host.global_and_local(c)
                                         for c in chains]


def test_rescore_mode_is_checked(setup, monkeypatch):
    for mode in ("auto", "pallas"):
        monkeypatch.setenv("GAT_RESCORE", mode)
        assert TorchChainScorer(*setup, device=CPU).mode == mode
    monkeypatch.setenv("GAT_RESCORE", "pair")
    port = TorchChainScorer(*setup, device=CPU)
    assert isinstance(port._dev, port_pair.TorchPairBlockScorer)
    assert port._dev.host_native is False
    for mode in ("hostnative", "xla", "Pair"):
        monkeypatch.setenv("GAT_RESCORE", mode)
        with pytest.raises(ValueError, match="ROADMAP.md"):
            TorchChainScorer(*setup, device=CPU)
    monkeypatch.setenv("GAT_RESCORE", "pair")
    monkeypatch.setenv("GAT_COMBINE", "gpu")
    with pytest.raises(ValueError, match="GAT_COMBINE"):
        TorchChainScorer(*setup, device=CPU).score_chains([])


def test_pair_mode_needs_an_int8_matrix(setup):
    scheme, _, t_genome, q_genome = setup
    lut = np.asarray(scheme.lut).astype(np.int64)
    lut[0, 0] = 200
    with pytest.raises(ValueError, match="int8"):
        port_pair.TorchPairBlockScorer(lut, t_genome, q_genome, CPU)


def test_pack_refuses_chunks_outside_the_genome(setup):
    scheme, _, t_genome, q_genome = setup
    pair = port_pair.TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                          q_genome, CPU)
    size = t_genome.codes("chrA", "+").shape[0]
    blocks = np.array([[size - 10, size + 5, 0, 15]], np.int64)
    with pytest.raises(IndexError):
        pair.block_scores("chrA", "chrQ1", "+", blocks)


def test_pack_without_native_library(setup, chain_sets, monkeypatch):
    """GAT_NATIVE=0: the numpy packer writes the same tiles."""
    import genomealignmenttools_tpu.native as nat
    scheme, _, t_genome, q_genome = setup
    jobs, _, _ = _jobs(setup, chain_sets["random"])
    native = port_pair.TorchPairBlockScorer(
        np.asarray(scheme.lut), t_genome, q_genome, CPU)._pack(jobs).tiles
    monkeypatch.setenv("GAT_NATIVE", "0")
    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_lib", None)
    plain = port_pair.TorchPairBlockScorer(
        np.asarray(scheme.lut), t_genome, q_genome, CPU)._pack(jobs).tiles
    assert nat.get_lib() is None
    assert np.array_equal(plain.numpy(), native.numpy())
