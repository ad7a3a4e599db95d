"""Pair mode of the port (ops/pair_rescore.py, TorchChainScorer(mode="pair"))
against the JAX reference.

On tests/fixtures/synthetic.chain (both strands) and a seeded random chain
set: the port's int8-tile chunk sums and block sums equal the JAX
PairBlockScorer's and the host's; TorchPairChainScorer.score and
score_chained equal the JAX PairChainScorer (its staged combine, as it runs
on the CPU), the host ChainScorer and the port's host-native scorer, through
one pass of K2's tile entry; the int32 guard sends a batch to the host
combine with the same scores; GAT_PAIR_CHUNK, GAT_RESCORE and GAT_COMBINE are
checked.  The pass itself, `pair_combine_scan_tiles_plain` + finish, equals
the JAX package's one-dispatch pass (`_fused_pass`, `_fused_pass_chained`,
scored tiles, the Pallas combine in interpret mode) on the adversarial cases
of tests/combine_cases.py at tile widths 2, 6, 128, 130 and 258.  Integer
math: every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from combine_cases import score_tiles
from genomealignmenttools_tpu.device.genome import Genome
from genomealignmenttools_tpu.engines.scoring import ChainScorer, block_scores
from genomealignmenttools_tpu.formats.chain import read_chains
from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops import pair_rescore as jax_pair
from genomealignmenttools_tpu_torch.device import PERF
from genomealignmenttools_tpu_torch.ops import pair_combine as pc
from genomealignmenttools_tpu_torch.ops import pair_rescore as port_pair
from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
from test_torch_pair_combine import _case
from test_torch_rescore import _random_chains
import variant_cases as vc

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
        tiles.numel() + 16 * tiles.shape[0]


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
    return gap_calc_from_file(vc.write_huge_gap_calc(str(tmp_path
                                                         / "huge.gap")))


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
    real = port_pair.pair_combine_scan_tiles

    def spy(*args):
        calls.append(args[0].shape[0])
        return real(*args)
    monkeypatch.setattr(port_pair, "pair_combine_scan_tiles", spy)
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
    # the host-native scorer runs when named, whatever the device says
    monkeypatch.setenv("GAT_RESCORE", "hostnative")
    port = TorchChainScorer(*setup, device=None)
    assert isinstance(port._dev, port_pair.TorchPairBlockScorer)
    assert port._dev.host_native is True and str(port.device) == CPU
    for mode in ("xla", "Pair"):
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
    import genomealignmenttools_tpu_torch.native as nat
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


CHUNKS = [2, 6, 128, 130, 258]


def _tile_case(name, chunk):
    """A combine case as int8 tiles of `chunk` bytes a row: its s clipped to
    what a row holds, rows padded to the Pallas tile."""
    s, bias, flags, _, end_idx, _ = _case(name)
    s = np.clip(s, -128 * chunk, 127 * chunk).astype(np.int32)
    return score_tiles(np.random.default_rng(chunk), s, chunk), bias, flags, \
        end_idx


def _jax_pass(tiles, bias, flags, end_idx, feedback=None):
    import jax.numpy as jnp
    args = [jnp.asarray(a) for a in (tiles, bias, flags, end_idx)]
    if feedback is None:
        out = jax_pair._fused_pass(args[0], None, *args[1:], interpret=True,
                                   scored=True)
    else:
        out = jax_pair._fused_pass_chained(
            args[0], None, *args[1:], jnp.asarray(feedback), interpret=True,
            scored=True)
    return np.asarray(out)


def _port_pass(tiles, bias, flags, end_idx, tweak=None):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (tiles, bias, flags, end_idx)]
    c, w = pc.pair_combine_scan_tiles_plain(*t[:3], tweak)
    return pc.pair_combine_finish(c, w, t[3]).numpy()


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", ["random-200", "edge", "multi-tile-chain"])
def test_tiles_pass_matches_jax_fused_pass(name, chunk):
    tiles, bias, flags, end_idx = _tile_case(name, chunk)
    got = _port_pass(tiles, bias, flags, end_idx)
    assert got.dtype == np.int32
    assert np.array_equal(got, _jax_pass(tiles, bias, flags, end_idx))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_tiles_pass_with_tweak_matches_jax_fused_pass_chained(chunk):
    """The chained pass's tweak: the reference adds 1 to every row sum when
    its feedback equals INT32_MIN; the port adds the tweak it is given."""
    tiles, bias, flags, end_idx = _tile_case("random-200", chunk)
    for fb, tweak in (([-2 ** 31, 0], 1), ([5, 0], 0)):
        want = _jax_pass(tiles, bias, flags, end_idx,
                         np.array(fb, np.int32))
        got = _port_pass(tiles, bias, flags, end_idx,
                         torch.tensor(tweak, dtype=torch.int32))
        assert np.array_equal(got, want)
    assert not np.array_equal(
        _port_pass(tiles, bias, flags, end_idx,
                   torch.tensor(1, dtype=torch.int32)),
        _port_pass(tiles, bias, flags, end_idx))


def test_chain_scorer_pass_is_one_tile_combine(setup, chain_sets,
                                               monkeypatch):
    """score and score_chained on the CPU go through one call of K2's tile
    entry a pass and never through the torch row sums; their scores equal
    the port's host-native scorer's."""
    from genomealignmenttools_tpu_torch.ops.rescore import torch_scorer_factory
    scheme, gc, t_genome, q_genome = setup
    chains = chain_sets["random"]
    jobs, nblocks, order = _jobs(setup, chains)
    port = port_pair.TorchPairChainScorer(
        port_pair.TorchPairBlockScorer(np.asarray(scheme.lut), t_genome,
                                       q_genome, CPU), gc)
    calls = []
    real = port_pair.pair_combine_scan_tiles

    def spy(tiles, *args):
        calls.append(tiles.shape)
        return real(tiles, *args)

    def no_row_sums(*_):
        raise AssertionError("the pass went through the torch row sums")
    monkeypatch.setattr(port_pair, "pair_combine_scan_tiles", spy)
    monkeypatch.setattr(port_pair.TorchPairBlockScorer, "chunk_sums",
                        no_row_sums)
    host = torch_scorer_factory(mode="hostnative")(scheme, gc, t_genome,
                                                   q_genome)
    want = [host.global_and_local(chains[i]) for i in order]
    assert port.score(jobs, nblocks) == want
    assert len(calls) == 1
    chained = port.score_chained(jobs, nblocks, 4)
    assert len(calls) == 5
    assert chained.tolist() == [[g, loc] for (g, loc, _) in want]
    tiles = port.pair._pack(jobs).tiles
    assert calls[0] == tiles.shape and tiles.shape[1] == port_pair.CHUNK


# --- the other tile formats: GAT_PAIR_TILES=code and =score4 --------------

FORMATS = ["code", "score4"]


@pytest.mark.parametrize("tiles", FORMATS)
@pytest.mark.parametrize("which", ["synthetic", "random"])
def test_formats_match_jax_pair_and_host(setup, chain_sets, monkeypatch,
                                         tiles, which):
    """Under GAT_PAIR_TILES=code and =score4 the port's block sums, chunk
    sums, score and score_chained(..., 3) equal the JAX PairBlockScorer's
    and PairChainScorer's under the same setting and the host ChainScorer's
    (test_device_rescore.py::test_score_tiles_vs_code_tiles_identical)."""
    monkeypatch.setenv("GAT_PAIR_TILES", tiles)
    scheme, gc, t_genome, q_genome = setup
    chains = chain_sets[which]
    jobs, nblocks, order = _jobs(setup, chains)
    lut = np.asarray(scheme.lut)
    port = port_pair.TorchPairBlockScorer(lut, t_genome, q_genome, CPU)
    ref = jax_pair.PairBlockScorer(lut, t_genome, q_genome)
    assert port.kind == tiles
    assert ref.score4_tiles == (tiles == "score4")
    assert ref.score_tiles == (tiles == "score4")
    got = port.block_scores_multi(jobs)
    assert np.array_equal(got, ref.block_scores_multi(jobs))
    host = ChainScorer(*setup)
    assert np.array_equal(got, np.concatenate(
        [host.score_arrays(chains[i])[0] for i in order]))
    cs, c_block, n_blocks = port.chunk_scores_multi(jobs)
    cs_j, c_block_j, n_blocks_j = ref.chunk_scores_multi(jobs)
    assert cs.dtype == np.int32 and np.array_equal(cs, cs_j)
    assert np.array_equal(c_block, c_block_j) and n_blocks == n_blocks_j
    pcs = port_pair.TorchPairChainScorer(port, gc)
    want = [host.global_and_local(chains[i]) for i in order]
    assert pcs.score(jobs, nblocks) == want
    assert jax_pair.PairChainScorer(ref, gc).score(jobs, nblocks) == want
    chained = pcs.score_chained(jobs, nblocks, 3)
    assert np.array_equal(chained.astype(np.int64), jax_pair.PairChainScorer(
        ref, gc).score_chained(jobs, nblocks, 3))
    assert chained.tolist() == [[g, loc] for (g, loc, _) in want]
    pack = port._pack(jobs)
    assert pack.kind == tiles
    width = port_pair.CHUNK // 2 if tiles == "score4" else port_pair.CHUNK
    assert pack.tiles.shape[1] == width and pack.tiles.dtype == torch.uint8
    assert (pack.tiles[pack.m:] == (24 if tiles == "code" else 0)).all()
    assert pcs.resident_hbm_bytes(jobs, nblocks) == \
        pack.tiles.shape[0] * (width + 16)


@pytest.mark.parametrize("tiles", FORMATS)
def test_format_pass_is_one_call_of_the_format(setup, chain_sets,
                                               monkeypatch, combine_calls,
                                               tiles):
    """TorchChainScorer in pair mode with the device combine calls the
    combine wrapper with the format's tiles, kind and table, one call a
    pass."""
    monkeypatch.setenv("GAT_PAIR_TILES", tiles)
    monkeypatch.setenv("GAT_COMBINE", "device")
    kinds = []
    real = port_pair.pair_combine_scan_tiles

    def spy(*args):
        kinds.append((args[0].dtype, args[0].shape[1], args[4]))
        return real(*args)
    monkeypatch.setattr(port_pair, "pair_combine_scan_tiles", spy)
    chains = chain_sets["random"]
    port = TorchChainScorer(*setup, device=CPU, mode="pair")
    host = ChainScorer(*setup)
    assert port.score_chains(chains) == [host.global_and_local(c)
                                         for c in chains]
    width = port_pair.CHUNK // 2 if tiles == "score4" else port_pair.CHUNK
    assert kinds == [(torch.uint8, width, tiles)]


@pytest.mark.parametrize("chunk", ["2", "130", "258"])
@pytest.mark.parametrize("tiles", FORMATS)
def test_formats_at_other_pair_chunks(setup, chain_sets, monkeypatch, tiles,
                                      chunk):
    """Any GAT_PAIR_CHUNK: 4-bit rows of 1, 65 (odd) and 129 bytes."""
    monkeypatch.setenv("GAT_PAIR_TILES", tiles)
    monkeypatch.setenv("GAT_PAIR_CHUNK", chunk)
    monkeypatch.setenv("GAT_COMBINE", "device")
    port = TorchChainScorer(*setup, device=CPU, mode="pair")
    chains = chain_sets["random"]
    host = ChainScorer(*setup)
    assert port.score_chains(chains) == [host.global_and_local(c)
                                         for c in chains]
    jobs, _ = port._grouped(chains)
    width = int(chunk) // 2 if tiles == "score4" else int(chunk)
    assert port._dev._pack(jobs).tiles.shape[1] == width


def test_more_than_16_values_gives_int8_tiles_in_both(setup, monkeypatch):
    """GAT_PAIR_TILES=score4 with a matrix of 17 distinct values (with 0):
    int8 score tiles in the port, as in the reference, same scores."""
    scheme, gc, t_genome, q_genome = setup
    lut = np.zeros((5, 5), np.int64)
    lut[:4, :4] = (np.arange(16) - 8).reshape(4, 4) * 7 + 1
    assert port_pair.pack_vals16(lut) is None
    monkeypatch.setenv("GAT_PAIR_TILES", "score4")
    port = port_pair.TorchPairBlockScorer(lut, t_genome, q_genome, CPU)
    ref = jax_pair.PairBlockScorer(lut, t_genome, q_genome)
    assert port.kind == "score8" and port.table is None
    assert ref.score_tiles and not ref.score4_tiles
    blocks = np.array([[100, 400, 200, 500], [600, 611, 700, 711]], np.int64)
    assert np.array_equal(port.block_scores("chrA", "chrQ1", "+", blocks),
                          ref.block_scores("chrA", "chrQ1", "+", blocks))


@pytest.mark.parametrize("tiles", [None, "code", "score4"])
@pytest.mark.parametrize("where,value", [((0, 0), 200), ((1, 2), -129),
                                         ((4, 1), 5), ((2, 4), -3)],
                         ids=["above-int8", "below-int8", "n-row", "n-col"])
def test_matrix_refused_in_every_format(setup, monkeypatch, tiles, where,
                                        value):
    """Outside int8, or a nonzero N row or column: the reference's pack_lut
    asserts (pallas_rescore.py:175-178) whatever GAT_PAIR_TILES says; the
    port raises ValueError."""
    scheme, _, t_genome, q_genome = setup
    if tiles is None:
        monkeypatch.delenv("GAT_PAIR_TILES", raising=False)
    else:
        monkeypatch.setenv("GAT_PAIR_TILES", tiles)
    lut = np.asarray(scheme.lut).astype(np.int64)
    lut[where] = value
    with pytest.raises(ValueError, match="pair mode needs"):
        port_pair.TorchPairBlockScorer(lut, t_genome, q_genome, CPU)
    with pytest.raises(AssertionError):
        jax_pair.PairBlockScorer(lut, t_genome, q_genome)


@pytest.mark.parametrize("value", ["int8", "", "Code", "score8", "dot"])
def test_unknown_pair_tiles_raises(setup, monkeypatch, value):
    monkeypatch.setenv("GAT_PAIR_TILES", value)
    with pytest.raises(ValueError, match="GAT_PAIR_TILES"):
        TorchChainScorer(*setup, device=CPU, mode="pair")
    # the host-native oracle packs no tiles and does not read it
    monkeypatch.setenv("GAT_RESCORE", "hostnative")
    assert TorchChainScorer(*setup, device=None)._dev.host_native


def test_bucket_rows_matches_reference():
    ms = [0, 1, 1023, 1024, 1025, 1280, 1281, 1536, 1537, 1792, 1793, 2047,
          2048, 2049, 4_374_528, 10 ** 7 + 1]
    assert [port_pair.bucket_rows(m) for m in ms] == \
        [jax_pair.bucket_rows(m) for m in ms]
    assert port_pair.bucket_rows(3000, 256) == jax_pair.bucket_rows(3000, 256)


def test_pack_vals16_matches_reference(setup):
    from combine_cases import WIDE_LUT
    scheme = setup[0]
    over = np.zeros((5, 5), np.int64)
    over[:4, :4] = np.arange(1, 17).reshape(4, 4)       # 17 values with 0
    wide = np.asarray(WIDE_LUT).copy()
    wide[3, 3] = 300                                    # outside int8
    for lut in (np.asarray(scheme.lut), WIDE_LUT, over, wide):
        got, want = port_pair.pack_vals16(lut), jax_pair.pack_vals16(lut)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0].dtype == want[0].dtype == np.uint8
            assert got[1].dtype == want[1].dtype == np.int32
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
    assert port_pair.pack_vals16(over) is None


@pytest.mark.parametrize("strand", ["+", "-"])
def test_pack_pairs_matches_reference(setup, chain_sets, strand):
    """pack_pairs: the reference's combined tiles byte for byte, rows
    bucketed, pad 24, the same chunk -> block map."""
    _, _, t_genome, q_genome = setup
    chains = [c for c in chain_sets["synthetic"] if c.q_strand == strand
              and c.t_name == "chrA" and c.q_name == "chrQ1"]
    blocks = np.concatenate([c.blocks for c in chains]).astype(np.int64)
    t_codes = t_genome.codes("chrA", "+")
    q_codes = q_genome.codes("chrQ1", strand)
    c8, c_block, m = port_pair.pack_pairs(t_codes, q_codes, blocks)
    c8_j, c_block_j, m_j = jax_pair.pack_pairs(t_codes, q_codes, blocks)
    assert m == m_j and c8.dtype == np.uint8
    assert c8.shape == c8_j.shape == (jax_pair.bucket_rows(m), 128)
    assert np.array_equal(c8, c8_j) and np.array_equal(c_block, c_block_j)
    assert (c8[m:] == 24).all()


def _random_chunks(seed, chunk, k=3000):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 5, 50_000).astype(np.uint8)
    q = rng.integers(0, 5, 40_000).astype(np.uint8)
    length = rng.integers(0, chunk + 1, k).astype(np.int64)
    length[:3] = [0, 1, chunk]
    t_off = rng.integers(0, t.shape[0] - chunk, k).astype(np.int64)
    q_off = rng.integers(0, q.shape[0] - chunk, k).astype(np.int64)
    t_off[2], q_off[2] = t.shape[0] - chunk, q.shape[0] - chunk
    return t, q, t_off, q_off, length


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("chunk", [2, 130])
def test_fill_formats_match_reference(setup, monkeypatch, native, chunk):
    """fill_combined and fill_scored4, through the native packers and
    through numpy (GAT_NATIVE=0), against the reference's _fill_combined and
    _fill_scored4; both refuse a chunk outside its genome."""
    import genomealignmenttools_tpu_torch.native as nat
    if not native:
        monkeypatch.setenv("GAT_NATIVE", "0")
        monkeypatch.setattr(nat, "_tried", False)
        monkeypatch.setattr(nat, "_lib", None)
    assert (nat.get_lib() is not None) == native
    t, q, t_off, q_off, length = _random_chunks(chunk, chunk)
    k = t_off.shape[0]
    idx_lut25, _ = port_pair.pack_vals16(np.asarray(setup[0].lut))
    got = np.empty((k, chunk), np.uint8)
    port_pair.fill_combined(t, q, t_off, q_off, length, got)
    want = np.empty_like(got)
    jax_pair._fill_combined(t, q, t_off, q_off, length, want, k, chunk)
    assert np.array_equal(got, want)
    got4 = np.empty((k, chunk // 2), np.uint8)
    port_pair.fill_scored4(t, q, t_off, q_off, length, got4, idx_lut25)
    want4 = np.empty_like(got4)
    jax_pair._fill_scored4(t, q, t_off, q_off, length, want4, k, chunk,
                           idx_lut25)
    assert np.array_equal(got4, want4)
    length[5] = chunk + 1
    with pytest.raises(IndexError):
        port_pair.fill_combined(t, q, t_off, q_off, length, got)
    length[5], length[6], t_off[6] = 1, 1, t.shape[0]
    with pytest.raises(IndexError):
        port_pair.fill_scored4(t, q, t_off, q_off, length, got4, idx_lut25)
