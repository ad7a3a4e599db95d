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

from genomealignmenttools_tpu.device.genome import Genome, revcomp_codes
from genomealignmenttools_tpu.formats.chain import read_chains
from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu_torch.device import LAUNCHES
from genomealignmenttools_tpu_torch.ops import window_rescore as wr
from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer

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
