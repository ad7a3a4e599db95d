"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one.  This file imports
nothing of jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from band_cases import N_KERNEL_CASES, kernel_cases, outcome, raw_inputs
from combine_cases import combine_case, edge_chains, random_chains
from genomealignmenttools_tpu.device.genome import Genome, revcomp_codes
from genomealignmenttools_tpu.formats.chain import read_chains
from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops.band_ext import band_ext
from genomealignmenttools_tpu_torch.device import LAUNCHES
from genomealignmenttools_tpu_torch.ops import band_batch as bb
from genomealignmenttools_tpu_torch.ops import pair_combine as pc
from genomealignmenttools_tpu_torch.ops import window_rescore as wr
from genomealignmenttools_tpu_torch.ops.pair_rescore import \
    pair_chain_scores_plain
from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
from genomealignmenttools_tpu_torch.parallel.dryrun import dryrun_multidevice
from genomealignmenttools_tpu_torch.parallel.mesh import (
    ShardedBlockScorer, ShardedChainScorer, ShardedPairScorer)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
LUT = wr.checked_lut(score_scheme_default().lut)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _chunks(seed, t_len=300_000, q_len=200_000, n=50_000):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, t_len).astype(np.uint8)
    q = rng.integers(0, 4, q_len).astype(np.uint8)
    for codes in (t, q):                              # N runs
        for s in rng.integers(0, codes.shape[0], 40):
            codes[s:s + int(rng.integers(1, 500))] = 4
    length = rng.integers(0, wr.CHUNK + 1, n).astype(np.int32)
    length[:4] = [0, 1, 255, 256]
    t_off = rng.integers(0, t_len - wr.CHUNK, n).astype(np.int64)
    q_off = rng.integers(0, q_len - wr.CHUNK, n).astype(np.int64)
    t_off[3], q_off[3] = t_len - 256, q_len - 256   # ends at the genome end
    t_off[0], q_off[0] = t_len, q_len               # empty, at the end
    return t, q, t_off, q_off, length


@pytest.mark.gpu
@pytest.mark.parametrize("strand", ["+", "-"])
def test_rescore_chunks_kernel_matches_plain(cuda_device, strand):
    t, q, t_off, q_off, length = _chunks(7)
    if strand == "-":
        q = revcomp_codes(q)
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (t, q, t_off, q_off, length)]
    before = LAUNCHES["rescore_chunks"]
    got = wr.chunk_sums(card[0], card[1], LUT, *card[2:])
    torch.cuda.synchronize()
    assert LAUNCHES["rescore_chunks"] == before + 1
    want = wr.chunk_sums_plain(card[0], card[1], LUT, *card[2:])
    assert got.dtype == torch.int32 and got.device == cuda_device
    assert torch.equal(got, want)
    cpu = wr.chunk_sums(*[torch.from_numpy(a) for a in (t, q)], LUT,
                        *[torch.from_numpy(a) for a in (t_off, q_off,
                                                        length)])
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.gpu
def test_rescore_chunks_refuses_out_of_range_on_cuda(cuda_device):
    t, q, t_off, q_off, length = _chunks(8, n=16)
    t_off[5] = t.shape[0]
    length[5] = 1
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (t, q, t_off, q_off, length)]
    before = LAUNCHES["rescore_chunks"]
    with pytest.raises(IndexError):
        wr.chunk_sums(card[0], card[1], LUT, *card[2:])
    assert LAUNCHES["rescore_chunks"] == before


@pytest.mark.gpu
def test_torch_chain_scorer_cuda_matches_cpu(cuda_device):
    scheme = score_scheme_default()
    gc = gap_calc_from_file("loose")
    t_genome = Genome(os.path.join(FIXTURES, "target.2bit"))
    q_genome = Genome(os.path.join(FIXTURES, "query.2bit"))
    chains = read_chains(os.path.join(FIXTURES, "synthetic.chain"))
    on_card = TorchChainScorer(scheme, gc, t_genome, q_genome,
                               device=cuda_device)
    on_cpu = TorchChainScorer(scheme, gc, t_genome, q_genome, device="cpu")
    before = LAUNCHES["rescore_chunks"]
    assert on_card.score_chains(chains) == on_cpu.score_chains(chains)
    assert LAUNCHES["rescore_chunks"] > before


def _combine_inputs(name):
    rng = np.random.default_rng(17)
    if name == "edge":           # carries across K2's tiles, pad chunks
        return combine_case(rng, *edge_chains(pc.TILE), pad_to=pc.TILE)
    if name == "ragged":         # no padding: K2 masks its last tile
        return combine_case(rng, *random_chains(rng, 300))
    return combine_case(rng, *random_chains(rng, 5000), pad_to=pc.TILE)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["edge", "ragged", "random"])
def test_pair_combine_kernel_matches_plain(cuda_device, name):
    s, bias, flags, start_idx, end_idx, _ = _combine_inputs(name)
    host = [torch.from_numpy(a) for a in (s, bias, flags, start_idx,
                                          end_idx)]
    card = [a.to(cuda_device) for a in host]
    before = LAUNCHES["pair_combine"]
    c, w = pc.pair_combine_scan(*card[:3])
    torch.cuda.synchronize()
    assert LAUNCHES["pair_combine"] == before + 1
    assert c.dtype == w.dtype == torch.int32 and c.device == cuda_device
    c_plain, w_plain = pc.pair_combine_scan_plain(*card[:3])
    assert torch.equal(c, c_plain) and torch.equal(w, w_plain)
    c_cpu, w_cpu = pc.pair_combine_scan(*host[:3])
    assert torch.equal(c.cpu(), c_cpu) and torch.equal(w.cpu(), w_cpu)
    fin = pc.pair_combine_finish(c, w, card[4])
    staged = pair_chain_scores_plain(*card[:3], card[3], card[4])
    assert torch.equal(fin.to(torch.int64), staged)


@pytest.mark.gpu
def test_torch_chain_scorer_pair_mode_cuda_matches_cpu(cuda_device,
                                                       monkeypatch):
    monkeypatch.setenv("GAT_COMBINE", "device")
    scheme = score_scheme_default()
    gc = gap_calc_from_file("loose")
    t_genome = Genome(os.path.join(FIXTURES, "target.2bit"))
    q_genome = Genome(os.path.join(FIXTURES, "query.2bit"))
    chains = read_chains(os.path.join(FIXTURES, "synthetic.chain"))
    on_card = TorchChainScorer(scheme, gc, t_genome, q_genome,
                               device=cuda_device, mode="pair")
    on_cpu = TorchChainScorer(scheme, gc, t_genome, q_genome, device="cpu",
                              mode="pair")
    before = LAUNCHES["pair_combine"]
    assert on_card.score_chains(chains) == on_cpu.score_chains(chains)
    assert LAUNCHES["pair_combine"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(N_KERNEL_CASES))
def test_band_ext_kernel_matches_plain(cuda_device, case):
    """K3 == band_ext_plain on the card, meta and moves exactly, on the case
    sets of chip_smoke.py's `kernel K3` phase."""
    sets = kernel_cases()
    assert len(sets) == N_KERNEL_CASES
    _label, global_mode, gap_open, gap_extend, mi, probs = sets[case]
    mat = bb.BandExtBatch(global_mode, score_scheme_default().char_matrix(),
                          gap_open, gap_extend, mi, device=cuda_device).mat
    args = raw_inputs(probs, cuda_device)
    before = LAUNCHES["band_ext"]
    meta, moves = bb.band_ext_cuda(*args, mat, global_mode, gap_open,
                                   gap_extend, mi)
    torch.cuda.synchronize()
    assert LAUNCHES["band_ext"] == before + 1
    assert meta.dtype == torch.int32 and meta.device == cuda_device
    plain = bb.band_ext_plain(*args, mat, global_mode, gap_open, gap_extend,
                              mi)
    assert torch.equal(meta, plain[0]) and torch.equal(moves, plain[1])


@pytest.mark.gpu
@pytest.mark.parametrize("global_mode", [False, True])
def test_band_ext_batch_cuda_matches_band_ext(cuda_device, global_mode):
    cm = score_scheme_default().char_matrix()
    probs = [p for s in kernel_cases() if s[1] == global_mode
             for p in s[5][:12]]
    for _label, g, gap_open, gap_extend, mi, _ in kernel_cases():
        if g != global_mode:
            continue
        batch = bb.BandExtBatch(g, cm, gap_open, gap_extend, mi,
                                device=cuda_device)
        want = [outcome(lambda p=p: band_ext(g, cm, gap_open, gap_extend,
                                             mi, *p)) for p in probs]
        fine = [p for p, w in zip(probs, want) if isinstance(w, tuple)]
        assert batch.run(fine) == [w for w in want if isinstance(w, tuple)]
        for p, w in zip(probs, want):
            if not isinstance(w, tuple):
                assert outcome(lambda p=p: batch.run([p])) is w


def _fixture_genomes():
    return (Genome(os.path.join(FIXTURES, "target.2bit")),
            Genome(os.path.join(FIXTURES, "query.2bit")),
            read_chains(os.path.join(FIXTURES, "synthetic.chain")))


@pytest.mark.gpu
def test_sharded_block_and_pair_scorers_cuda_match_single_device(
        cuda_device):
    lut = np.asarray(score_scheme_default().lut)
    t_genome, q_genome, chains = _fixture_genomes()
    blocks = np.concatenate([c.blocks for c in chains if c.t_name == "chrA"
                             and c.q_name == "chrQ1" and c.q_strand == "+"])
    args = (t_genome.codes("chrA"), q_genome.codes("chrQ1"), blocks)
    before = LAUNCHES["rescore_chunks"]
    got = ShardedBlockScorer(lut, [cuda_device] * 2).block_scores(*args)
    assert LAUNCHES["rescore_chunks"] == before + 2
    one = ShardedBlockScorer(lut, [cuda_device]).block_scores(*args)
    cpu = ShardedBlockScorer(lut, ["cpu"]).block_scores(*args)
    assert np.array_equal(got, one) and np.array_equal(got, cpu)
    pair = ShardedPairScorer(lut, [cuda_device] * 2)
    tiles, _, _ = pair.pack(*args)
    assert np.array_equal(pair.chunk_scores(tiles),
                          ShardedPairScorer(lut, ["cpu"]).chunk_scores(tiles))


@pytest.mark.gpu
def test_sharded_chain_scorer_cuda_matches_single_device(cuda_device,
                                                         monkeypatch):
    monkeypatch.setenv("GAT_COMBINE", "device")
    scheme, gc = score_scheme_default(), gap_calc_from_file("loose")
    t_genome, q_genome, chains = _fixture_genomes()
    one = TorchChainScorer(scheme, gc, t_genome, q_genome,
                           device=cuda_device, mode="pair")
    before = LAUNCHES["pair_combine"]
    want = one.score_chains(chains)
    assert LAUNCHES["pair_combine"] == before + 1
    before = LAUNCHES["pair_combine"]
    got = ShardedChainScorer(scheme, gc, t_genome, q_genome,
                             [cuda_device] * 2).score_chains(chains)
    assert LAUNCHES["pair_combine"] == before + 2
    assert got == want


@pytest.mark.gpu
def test_dryrun_multidevice_cuda(cuda_device):
    before = dict(LAUNCHES)
    dryrun_multidevice([cuda_device] * 2)
    assert all(LAUNCHES[k] > before[k] for k in LAUNCHES)
