"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one.  This file imports
only the port (its oracles are the port's own copies of the numpy layers), so
it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from band_cases import (N_INSTANTIATION_CASES, N_KERNEL_CASES,
                        instantiation_cases, kernel_cases, outcome,
                        raw_inputs)
import hsp_cases
from combine_cases import (WIDE_LUT, code_tiles, code_tiles_torch,
                           combine_case, edge_chains, even_tiles_torch,
                           nibble_tiles, random_chains, score_tiles,
                           scored_tiles)
from genomealignmenttools_tpu_torch.device import LAUNCHES
from genomealignmenttools_tpu_torch.device.genome import Genome, revcomp_codes
from genomealignmenttools_tpu_torch.formats.chain import read_chains
from genomealignmenttools_tpu_torch.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu_torch.formats.scorematrix import \
    score_scheme_default
from genomealignmenttools_tpu_torch.ops import band_batch as bb
from genomealignmenttools_tpu_torch.ops import hsp_scan as hs
from genomealignmenttools_tpu_torch.ops.band_ext import band_ext
from genomealignmenttools_tpu_torch.ops import pair_combine as pc
from genomealignmenttools_tpu_torch.ops import window_rescore as wr
from genomealignmenttools_tpu_torch.ops.pair_rescore import (
    pack_pairs, pack_vals16, pair_chain_scores_plain, vals16_of)
from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
from genomealignmenttools_tpu_torch.parallel.dryrun import dryrun_multidevice
from genomealignmenttools_tpu_torch.parallel.mesh import (
    ShardedBlockScorer, ShardedChainScorer, ShardedPairScorer)
from rescore_cases import alignment_case, direct_sums

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
@pytest.mark.parametrize("view", ["whole", "offset views"])
def test_rescore_chunks_kernel_every_alignment(cuda_device, view):
    """Every (t_off mod 16, q_off mod 16) pair at the lengths 0, 1, 15, 16,
    17, 255 and 256, and chunks that end at the last byte of a genome: K1's
    16-byte loads against the plain version and the definition.  As offset
    views, the code tensors themselves start off a 16-byte boundary."""
    t, q, t_off, q_off, length = alignment_case()
    want = direct_sums(t, q, LUT.numpy(), t_off, q_off, length)
    if view == "offset views":
        t, q, t_off, q_off = t[3:], q[9:], t_off - 3, q_off - 9
        keep = (t_off >= 0) & (q_off >= 0)
        t_off, q_off, length, want = (a[keep] for a in (t_off, q_off, length,
                                                        want))
        t_card = torch.from_numpy(np.concatenate(
            [np.full(3, 9, np.uint8), t])).to(cuda_device)[3:]
        q_card = torch.from_numpy(np.concatenate(
            [np.full(9, 9, np.uint8), q])).to(cuda_device)[9:]
    else:
        t_card = torch.from_numpy(t).to(cuda_device)
        q_card = torch.from_numpy(q).to(cuda_device)
    chunks = [torch.from_numpy(a).to(cuda_device)
              for a in (t_off, q_off, length)]
    got = wr.chunk_sums(t_card, q_card, LUT, *chunks)
    plain = wr.chunk_sums_plain(t_card, q_card, LUT, *chunks)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy().astype(np.int64), want)


@pytest.mark.gpu
def test_rescore_chunks_kernel_any_byte_is_n(cuda_device):
    """A code >= 4, whatever the byte, scores 0 on either side."""
    t, q, t_off, q_off, length = _chunks(9, n=20_000)
    rng = np.random.default_rng(10)
    for codes in (t, q):
        at = rng.integers(0, codes.shape[0], 5_000)
        codes[at] = rng.integers(4, 256, at.shape[0]).astype(np.uint8)
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (t, q, t_off, q_off, length)]
    got = wr.chunk_sums(card[0], card[1], LUT, *card[2:])
    assert torch.equal(got, wr.chunk_sums_plain(card[0], card[1], LUT,
                                                *card[2:]))


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
    again = pc.pair_combine_scan(*card[:3])     # same bits in any block order
    torch.cuda.synchronize()
    assert LAUNCHES["pair_combine"] == before + 2
    assert torch.equal(c, again[0]) and torch.equal(w, again[1])
    assert c.dtype == w.dtype == torch.int32 and c.device == cuda_device
    c_plain, w_plain = pc.pair_combine_scan_plain(*card[:3])
    assert torch.equal(c, c_plain) and torch.equal(w, w_plain)
    c_cpu, w_cpu = pc.pair_combine_scan(*host[:3])
    assert torch.equal(c.cpu(), c_cpu) and torch.equal(w.cpu(), w_cpu)
    fin = pc.pair_combine_finish(c, w, card[4])
    staged = pair_chain_scores_plain(*card[:3], card[3], card[4])
    assert torch.equal(fin.to(torch.int64), staged)


def _tiles_against_plain(tiles, s, bias, flags, start_idx, end_idx, tweak):
    """K2's tile entry twice (the same bits both times), against its plain
    version on the card and, finished, against the staged int64 combine of
    s + tweak."""
    before = LAUNCHES["pair_combine"]
    c, w = pc.pair_combine_scan_tiles(tiles, bias, flags, tweak)
    again = pc.pair_combine_scan_tiles(tiles, bias, flags, tweak)
    torch.cuda.synchronize()
    assert LAUNCHES["pair_combine"] == before + 2
    assert torch.equal(c, again[0]) and torch.equal(w, again[1])
    assert c.dtype == w.dtype == torch.int32 and c.device == tiles.device
    c_plain, w_plain = pc.pair_combine_scan_tiles_plain(tiles, bias, flags,
                                                        tweak)
    assert torch.equal(c, c_plain) and torch.equal(w, w_plain)
    s_tw = s if tweak is None else (s + tweak).to(torch.int32)
    staged = pair_chain_scores_plain(s_tw, bias, flags, start_idx, end_idx)
    fin = pc.pair_combine_finish(c, w, end_idx)
    assert torch.equal(fin.to(torch.int64), staged)
    return c, w


@pytest.mark.gpu
@pytest.mark.parametrize("tweak", [None, 7])
@pytest.mark.parametrize("chunk", [2, 6, 128, 130, 258])
@pytest.mark.parametrize("name", ["edge", "ragged", "random"])
def test_pair_combine_tiles_kernel_matches_plain(cuda_device, name, chunk,
                                                 tweak):
    """The tile entry at the default width (16-byte loads) and at the
    reference's other widths, none a multiple of 16 (a row a thread), with
    and without a tweak, on int8 rows whose sums are the cases' s, clipped
    to what `chunk` int8 bytes hold (a no-op from 128 bytes on)."""
    s, bias, flags, start_idx, end_idx, _ = _combine_inputs(name)
    s = np.clip(s, -128 * chunk, 127 * chunk).astype(s.dtype)
    tiles = score_tiles(np.random.default_rng(chunk), s, chunk)
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (tiles, s, bias, flags, start_idx, end_idx)]
    tw = None if tweak is None else torch.tensor(tweak, dtype=torch.int32,
                                                 device=cuda_device)
    c, w = _tiles_against_plain(*card, tw)
    host = pc.pair_combine_scan_tiles(*[torch.from_numpy(a) for a in (
        tiles, bias, flags)], None if tw is None else tw.cpu())
    assert torch.equal(c.cpu(), host[0]) and torch.equal(w.cpu(), host[1])


@pytest.mark.gpu
def test_pair_combine_tiles_kernel_many_tiles(cuda_device):
    """200,000 random chains: about 26 million chunks in some 13,000 tiles,
    far more than the card holds blocks at once, so the look-back crosses
    many tiles and blocks finish in every order."""
    rng = np.random.default_rng(31)
    s, bias, flags, start_idx, end_idx, m = combine_case(
        rng, *random_chains(rng, 200_000))
    assert m // pc.TILE > 10_000
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (s, bias, flags, start_idx, end_idx)]
    tiles = even_tiles_torch(card[0], 128)
    tw = torch.tensor(1, dtype=torch.int32, device=cuda_device)
    _tiles_against_plain(tiles, *card, tw)


IDX_LUT25, VALS_PACKED = pack_vals16(WIDE_LUT)
TABLES = {"code": torch.from_numpy(WIDE_LUT.reshape(25).astype(np.int8)),
          "score4": torch.from_numpy(vals16_of(VALS_PACKED))}


def _format_against_plain(kind, tiles, s8, bias, flags, start_idx, end_idx,
                          tweak):
    """The format's K2 entry twice (the same bits both times), against its
    plain version on the card, against K2's int8 entry on the int8 tiles of
    the same bases, and, finished, against the staged int64 combine."""
    key = pc.LAUNCH_KEY[kind]
    before = LAUNCHES[key]
    c, w = pc.pair_combine_scan_tiles(tiles, bias, flags, tweak, kind,
                                      TABLES[kind])
    again = pc.pair_combine_scan_tiles(tiles, bias, flags, tweak, kind,
                                       TABLES[kind])
    torch.cuda.synchronize()
    assert LAUNCHES[key] == before + 2
    assert torch.equal(c, again[0]) and torch.equal(w, again[1])
    assert c.dtype == w.dtype == torch.int32 and c.device == tiles.device
    plain = pc.pair_combine_scan_tiles_plain(tiles, bias, flags, tweak, kind,
                                             TABLES[kind])
    assert torch.equal(c, plain[0]) and torch.equal(w, plain[1])
    int8 = pc.pair_combine_scan_tiles(s8, bias, flags, tweak)
    assert torch.equal(c, int8[0]) and torch.equal(w, int8[1])
    s = s8.sum(dim=1, dtype=torch.int32)
    s_tw = s if tweak is None else (s + tweak).to(torch.int32)
    staged = pair_chain_scores_plain(s_tw, bias, flags, start_idx, end_idx)
    fin = pc.pair_combine_finish(c, w, end_idx)
    assert torch.equal(fin.to(torch.int64), staged)
    return c, w


@pytest.mark.gpu
@pytest.mark.parametrize("tweak", [None, 7])
@pytest.mark.parametrize("chunk", [2, 6, 128, 130, 258])
@pytest.mark.parametrize("kind", ["code", "score4"])
@pytest.mark.parametrize("name", ["edge", "ragged", "random"])
def test_pair_combine_format_kernel_matches_plain(cuda_device, name, kind,
                                                  chunk, tweak):
    """Combined-code rows of 128 bytes (16-byte loads) and of 2, 6, 130 and
    258 (a row a thread), 4-bit rows of 64 bytes (16-byte loads) and of 1, 3,
    65 and 129 (odd: byte loads), with and without a tweak."""
    _, bias, flags, start_idx, end_idx, m = _combine_inputs(name)
    codes = code_tiles(np.random.default_rng(chunk), bias.shape[0], chunk)
    codes[m:] = 24
    tiles = codes if kind == "code" else nibble_tiles(codes, IDX_LUT25)
    card = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
            for a in (tiles, scored_tiles(codes, WIDE_LUT), bias, flags,
                      start_idx, end_idx)]
    tw = None if tweak is None else torch.tensor(tweak, dtype=torch.int32,
                                                 device=cuda_device)
    c, w = _format_against_plain(kind, *card, tw)
    host = pc.pair_combine_scan_tiles(
        *[torch.from_numpy(np.ascontiguousarray(a))
          for a in (tiles, bias, flags)],
        None if tw is None else tw.cpu(), kind, TABLES[kind])
    assert torch.equal(c.cpu(), host[0]) and torch.equal(w.cpu(), host[1])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["code", "score4"])
def test_pair_combine_format_kernel_many_tiles(cuda_device, kind):
    """200,000 random chains, rows built on the card: the look-back crosses
    many tiles and blocks finish in every order."""
    rng = np.random.default_rng(31)
    _, bias, flags, start_idx, end_idx, m = combine_case(
        rng, *random_chains(rng, 200_000))
    assert m // pc.TILE > 10_000
    codes = code_tiles_torch(m, 128, cuda_device, seed=5)
    tiles = codes if kind == "code" else nibble_tiles(codes, IDX_LUT25)
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (bias, flags, start_idx, end_idx)]
    tw = torch.tensor(1, dtype=torch.int32, device=cuda_device)
    _format_against_plain(kind, tiles, scored_tiles(codes, WIDE_LUT), *card,
                          tw)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["code", "score4"])
def test_pair_combine_format_refusals_on_cuda(cuda_device, kind):
    """The wrapper refuses on CUDA tensors before any launch (a table on the
    card, misaligned tiles, a width K2 does not take); the C entry itself
    returns cudaErrorInvalidValue for a width or an alignment it does not
    take, and nothing is counted."""
    key = pc.LAUNCH_KEY[kind]
    width = 64 if kind == "score4" else 128
    z = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    tiles = torch.zeros((8, width), dtype=torch.uint8, device=cuda_device)
    before = LAUNCHES[key]
    with pytest.raises(TypeError):
        pc.pair_combine_scan_tiles(tiles, z, z, None, kind,
                                   TABLES[kind].to(cuda_device))
    flat = torch.zeros(8 * width + 16, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        pc.pair_combine_scan_tiles(flat[1:1 + 8 * width].view(8, width), z, z,
                                   None, kind, TABLES[kind])
    bad = 131 if kind == "score4" else 129
    wide = torch.zeros((8, bad), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        pc.pair_combine_scan_tiles(wide, z, z, None, kind, TABLES[kind])
    with pytest.raises(RuntimeError, match="launch failed"):
        pc._launch_tiles(wide, z, z, None, kind, TABLES[kind])
    with pytest.raises(RuntimeError, match="launch failed"):
        pc._launch_tiles(flat[1:1 + 8 * width].view(8, width), z, z, None,
                         kind, TABLES[kind])
    assert LAUNCHES[key] == before


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", ["code", "score4"])
def test_pair_pass_formats_cuda(cuda_device, monkeypatch, tiles):
    """TorchPairChainScorer under GAT_PAIR_TILES=code and =score4 on the
    card: the host-native scores, one launch of the format's entry a pass,
    none of the int8 entry."""
    from genomealignmenttools_tpu_torch.ops import pair_rescore as pr
    from genomealignmenttools_tpu_torch.ops.rescore import torch_scorer_factory
    monkeypatch.setenv("GAT_PAIR_TILES", tiles)
    scheme = score_scheme_default()
    gc = gap_calc_from_file("loose")
    t_genome = Genome(os.path.join(FIXTURES, "target.2bit"))
    q_genome = Genome(os.path.join(FIXTURES, "query.2bit"))
    chains = read_chains(os.path.join(FIXTURES, "synthetic.chain"))
    scorer = TorchChainScorer(scheme, gc, t_genome, q_genome,
                              device=cuda_device, mode="pair")
    assert scorer._dev.kind == tiles
    jobs, order = scorer._grouped(chains)
    nblocks = [chains[i].n_blocks for i in order]
    pcs = pr.TorchPairChainScorer(scorer._dev, gc)
    host = torch_scorer_factory(mode="hostnative")(scheme, gc, t_genome,
                                                   q_genome)
    want = [host.global_and_local(chains[i]) for i in order]
    key = pc.LAUNCH_KEY[tiles]
    before, int8 = LAUNCHES[key], LAUNCHES["pair_combine"]
    assert pcs.score(jobs, nblocks) == want
    chained = pcs.score_chained(jobs, nblocks, 3)
    assert LAUNCHES[key] == before + 4 and LAUNCHES["pair_combine"] == int8
    assert chained.tolist() == [[g, loc] for (g, loc, _) in want]
    # the torch row sums of the format (chunk_sums), summed per block
    assert np.array_equal(scorer._dev.block_scores_multi(jobs),
                          host._dev.block_scores_multi(jobs))


@pytest.mark.gpu
def test_pair_pass_never_takes_the_torch_row_sums(cuda_device, monkeypatch):
    """TorchPairChainScorer's pass on the card reads the tiles in K2 itself:
    with TorchPairBlockScorer.chunk_sums made to raise, score and
    score_chained still give the host-native scores, one launch a pass."""
    from genomealignmenttools_tpu_torch.ops import pair_rescore as pr
    from genomealignmenttools_tpu_torch.ops.rescore import torch_scorer_factory

    def no_row_sums(*_):
        raise AssertionError("the pass went through the torch row sums")
    monkeypatch.setattr(pr.TorchPairBlockScorer, "chunk_sums", no_row_sums)
    scheme = score_scheme_default()
    gc = gap_calc_from_file("loose")
    t_genome = Genome(os.path.join(FIXTURES, "target.2bit"))
    q_genome = Genome(os.path.join(FIXTURES, "query.2bit"))
    chains = read_chains(os.path.join(FIXTURES, "synthetic.chain"))
    scorer = TorchChainScorer(scheme, gc, t_genome, q_genome,
                              device=cuda_device, mode="pair")
    jobs, order = scorer._grouped(chains)
    nblocks = [chains[i].n_blocks for i in order]
    pcs = pr.TorchPairChainScorer(scorer._dev, gc)
    host = torch_scorer_factory(mode="hostnative")(scheme, gc, t_genome,
                                                   q_genome)
    want = [host.global_and_local(chains[i]) for i in order]
    before = LAUNCHES["pair_combine"]
    assert pcs.score(jobs, nblocks) == want
    assert LAUNCHES["pair_combine"] == before + 1
    chained = pcs.score_chained(jobs, nblocks, 3)
    assert LAUNCHES["pair_combine"] == before + 4
    assert chained.tolist() == [[g, loc] for (g, loc, _) in want]


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
@pytest.mark.parametrize("case", range(N_INSTANTIATION_CASES))
def test_band_ext_kernel_every_instantiation(cuda_device, case):
    """K3 == band_ext_plain at a max_insert of every cells-per-lane count (1
    to 8, one instantiation of the kernel each), in both modes."""
    sets = instantiation_cases()
    assert len(sets) == N_INSTANTIATION_CASES
    assert {bb.parent_layout(s[4])[0] for s in sets} == set(range(1, 9))
    _label, global_mode, gap_open, gap_extend, mi, probs = sets[case]
    mat = bb.BandExtBatch(global_mode, score_scheme_default().char_matrix(),
                          gap_open, gap_extend, mi, device=cuda_device).mat
    args = raw_inputs(probs, cuda_device)
    meta, moves = bb.band_ext_cuda(*args, mat, global_mode, gap_open,
                                   gap_extend, mi)
    plain = bb.band_ext_plain(*args, mat, global_mode, gap_open, gap_extend,
                              mi)
    torch.cuda.synchronize()
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


@pytest.mark.gpu
def test_hsp_best_kernel_matches_plain(cuda_device):
    """K4 == hsp_best_plain on the card, exactly, on the edge cases of
    tests/hsp_cases.py, and both equal a numpy Kadane; one launch."""
    t, q, t_start, q_start, length = hsp_cases.edge_case()
    lut = torch.from_numpy(hsp_cases.hsp_lut().astype(np.int32))
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (t, q, t_start, q_start, length)]
    before = LAUNCHES["hsp_best"]
    got = hs.hsp_best(card[0], card[1], lut, *card[2:])
    torch.cuda.synchronize()
    assert LAUNCHES["hsp_best"] == before + 1
    assert got.dtype == torch.int32 and got.device == cuda_device
    assert torch.equal(got, hs.hsp_best_plain(card[0], card[1], lut,
                                              *card[2:]))
    assert np.array_equal(got.cpu().numpy(), hsp_cases.kadane(
        t, q, t_start, q_start, length, hsp_cases.hsp_lut()))


@pytest.mark.gpu
def test_hsp_best_refuses_windows_outside_on_cuda(cuda_device):
    t, q, t_start, q_start, length = (
        torch.from_numpy(a).to(cuda_device) for a in hsp_cases.edge_case())
    lut = torch.from_numpy(hsp_cases.hsp_lut().astype(np.int32))
    with pytest.raises(IndexError):
        hs.hsp_best(t, q, lut, t_start + t.numel(), q_start, length)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,n_gaps", [("patchchain.gaps", 1000),
                                         ("repeatfiller.gaps", 600)])
def test_align_scan_batch_cuda_matches_host_scan(cuda_device, tmp_path, cell,
                                                 n_gaps):
    """At a gap-filling cell's chunk (its generator and configuration, its
    gaps a call), the chunk-wide scan's HSP rows, one K4 launch, equal the
    host scan's gap by gap and in order."""
    aligner, seeded = hsp_cases.cell_chunk(cell, str(tmp_path), 2500000011,
                                           n_gaps, cuda_device)
    want = [None if s is None else aligner.align_scan(s) for s in seeded]
    before = LAUNCHES["hsp_best"]
    assert aligner.align_scan_batch(seeded) == want
    assert LAUNCHES["hsp_best"] == before + 1
    assert sum(len(w) for w in want if w) > n_gaps


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
    tiles, _, _ = pack_pairs(*args)
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
    """The dry run launches K1, K2 (int8 tiles) and K3."""
    before = dict(LAUNCHES)
    dryrun_multidevice([cuda_device] * 2)
    assert all(LAUNCHES[k] > before[k]
               for k in ("rescore_chunks", "pair_combine", "band_ext"))
