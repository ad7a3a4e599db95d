"""The port's band batch (ops/band_batch.py) against the reference's.

On the CPU the port runs K3's plain PyTorch version.  Every comparison is
exact, tuple for tuple: against numpy ops/band_ext.band_ext (the bit-exact
kent bandExt port) and against the JAX Pallas kernel in interpret mode
(pallas_band.BandExtBatch(..., interpret=True)) on the same seeded problems.
"""

import numpy as np
import pytest
import torch

from band_cases import (GLOBAL_OUT_OF_BAND, LOCAL_OUT_OF_BAND, STALE_UP,
                        WANDERED, edge_problems, pallas_problems,
                        random_problems, raw_inputs, wandering_problems)
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops import pallas_band
from genomealignmenttools_tpu.ops.band_ext import band_ext
from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.ops import band_batch as bb

CM = score_scheme_default().char_matrix()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain band DP is thousands of small torch ops; under the
    parallel test runner, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(global_mode, probs, max_insert, gap_open=400, gap_extend=30):
    return [band_ext(global_mode, CM, gap_open, gap_extend, max_insert,
                     a, b, d) for a, b, d in probs]


def _port(global_mode, probs, max_insert, gap_open=400, gap_extend=30,
          **kw):
    return bb.BandExtBatch(global_mode, CM, gap_open, gap_extend, max_insert,
                           device="cpu", **kw).run(probs)


@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("max_insert", [7, 20])
def test_plain_matches_pallas_interpret_and_band_ext(global_mode, max_insert):
    probs = pallas_problems(3)
    pallas = pallas_band.BandExtBatch(global_mode, CM, 400, 30, max_insert,
                                      a_max=256, interpret=True).run(probs)
    got = _port(global_mode, probs, max_insert, a_max=256)
    assert got == pallas
    assert got == _oracle(global_mode, probs, max_insert)


@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("max_insert", [7, 20, 100])
def test_plain_matches_band_ext(global_mode, max_insert):
    rng = np.random.default_rng(100 + max_insert)
    probs = random_problems(rng, 40, 300, max_insert) + edge_problems()
    perf_reset()
    got = _port(global_mode, probs, max_insert)
    assert got == _oracle(global_mode, probs, max_insert)
    # empty sides are answered on the host, without the batch
    assert PERF["band_problems"] == len(probs) - 3
    assert any(r[0] for r in got) and not all(r[0] for r in got)


@pytest.mark.parametrize("global_mode", [False, True])
def test_long_problems_with_n_runs(global_mode):
    """Lengths up to 2,000 (GapAligner's max_ext) at max_insert 100."""
    rng = np.random.default_rng(7)
    probs = random_problems(rng, 8, 2000, 100)
    assert max(len(a) for a, _, _ in probs) > 1000
    got = _port(global_mode, probs, 100)
    assert got == _oracle(global_mode, probs, 100)


@pytest.mark.parametrize("max_insert", [7, 20, 100])
def test_wandering_band_global(max_insert):
    """`a` far longer than `b`: the band runs off `b` (n <= 0 columns) and
    the empty columns still go through the best / drop decision."""
    probs = wandering_problems(np.random.default_rng(5), 6, max_insert)
    got = _port(True, probs, max_insert)
    assert got == _oracle(True, probs, max_insert)
    assert all(r[0] for r in got)


def test_out_of_band_global_returns_false():
    max_insert, prob = GLOBAL_OUT_OF_BAND[0]
    perf_reset()
    got = _port(True, [prob, prob], max_insert)
    want = _oracle(True, [prob], max_insert)[0]
    assert got == [want, want] and want[0] is False
    assert PERF["band_out_of_band"] == 2


@pytest.mark.parametrize("case", range(len(LOCAL_OUT_OF_BAND)))
def test_out_of_band_local_raises(case):
    gap_open, gap_extend, max_insert, prob = LOCAL_OUT_OF_BAND[case]
    with pytest.raises(AssertionError):
        _oracle(False, [prob], max_insert, gap_open, gap_extend)
    with pytest.raises(AssertionError, match="out of band"):
        _port(False, [prob], max_insert, gap_open, gap_extend)
    # global mode on the same problem agrees
    assert _port(True, [prob], max_insert, gap_open, gap_extend) == _oracle(
        True, [prob], max_insert, gap_open, gap_extend)


@pytest.mark.parametrize("case", range(len(STALE_UP)))
def test_stale_up_cells(case):
    """The state arrays are never cleared: these results read up-state
    cells written two columns earlier."""
    global_mode, max_insert, prob = STALE_UP[case]
    assert _port(global_mode, [prob], max_insert) == _oracle(
        global_mode, [prob], max_insert)


def test_wandered_band_raises_index_error():
    max_insert, prob = WANDERED[0]
    with pytest.raises(IndexError):
        _oracle(True, [prob], max_insert)
    with pytest.raises(IndexError):
        _port(True, [prob], max_insert)


def test_sub_batches_give_the_same_results(monkeypatch):
    rng = np.random.default_rng(11)
    probs = random_problems(rng, 30, 200, 20)
    whole = _port(False, probs, 20)
    monkeypatch.setattr(bb, "PARENT_BUDGET", 41 * 200 * 3)
    split = _port(False, probs, 20)
    assert split == whole == _oracle(False, probs, 20)
    ranges = bb.sub_batches([len(a) for a, _, _ in probs], 20, dense=True,
                            budget=41 * 200 * 3)
    assert len(ranges) > 5
    assert ranges[0][0] == 0 and ranges[-1][1] == len(probs)
    assert bb.sub_batches([500], 20, dense=False, budget=10) == [(0, 1)]


def test_constructor_and_run_refusals(monkeypatch):
    with pytest.raises(ValueError, match="max_insert"):
        bb.BandExtBatch(False, CM, 400, 30, 128, device="cpu")
    batch = bb.BandExtBatch(False, CM, 400, 30, 7, a_max=256, device="cpu")
    with pytest.raises(ValueError, match="a_max"):
        batch.run([(b"A" * 257, b"ACGT", 1)])
    assert batch.run([]) == []
    with pytest.raises(ValueError, match="int32"):
        bb.BandExtBatch(False, CM, 10 ** 7, 30, 7, device="cpu")
    monkeypatch.setenv("GAT_BAND", "pallas")
    with pytest.raises(ValueError, match="GAT_BAND"):
        bb.BandExtBatch(False, CM, 400, 30, 7, device="cpu")
    # the host band batch runs only when named, and resolves no device
    monkeypatch.setenv("GAT_BAND", "host")
    assert bb.BandExtBatch(False, CM, 400, 30, 7).device is None


def test_wrapper_refuses_bad_inputs():
    mat = bb.BandExtBatch(False, CM, 400, 30, 7, device="cpu").mat
    a, a_off, b, b_off = raw_inputs([(b"ACGT", b"ACG", 1), (b"GG", b"GGA", 1)],
                                    "cpu")
    meta, moves = bb.band_ext_batch(a, a_off, b, b_off, mat, False, 400, 30,
                                    7)
    assert meta.shape == (2, 6) and meta.dtype == torch.int32
    assert moves.numel() == a.numel() + b.numel()
    with pytest.raises(TypeError):
        bb.band_ext_batch(a.to(torch.int32), a_off, b, b_off, mat, False,
                          400, 30, 7)
    with pytest.raises(ValueError, match="every problem a base"):
        bb.band_ext_batch(a, torch.tensor([0, 4, 4, 6]), b,
                          torch.tensor([0, 3, 4, 6]), mat, False, 400, 30, 7)
    with pytest.raises(ValueError, match="codes must be 0..4"):
        bb.band_ext_batch(a + 5, a_off, b, b_off, mat, False, 400, 30, 7)
    with pytest.raises(ValueError, match="max_insert"):
        bb.band_ext_batch(a, a_off, b, b_off, mat, False, 400, 30, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bb.band_ext_cuda(a, a_off, b, b_off, mat, False, 400, 30, 7)


@pytest.mark.parametrize("max_insert,cells,row_bytes", [
    (0, 1, 32), (1, 1, 32), (7, 1, 32), (15, 1, 32), (16, 2, 32),
    (20, 2, 32), (31, 2, 32), (32, 3, 64), (40, 3, 64), (60, 4, 64),
    (63, 4, 64), (64, 5, 128), (70, 5, 128), (80, 6, 128), (100, 7, 128),
    (127, 8, 128)])
def test_parent_layout(max_insert, cells, row_bytes):
    """K3's packed parent scratch: cells a lane, bytes a column; 32 lanes
    hold the whole band, and the word holds the lane's 4-bit parents."""
    assert bb.parent_layout(max_insert) == (cells, row_bytes)
    assert 32 * cells >= 2 * max_insert + 1 > 32 * (cells - 1)
    assert row_bytes // 32 * 8 >= 4 * cells


@pytest.mark.parametrize("max_insert", [1, 7, 20, 40, 60, 70, 80, 100, 127])
def test_parent_pack_round_trip(max_insert):
    """pack_parents / unpack_parents: cell j of a column is nibble j % C of
    word j // C, for every cells-per-lane count."""
    rng = np.random.default_rng(max_insert)
    band = 2 * max_insert + 1
    cells, row_bytes = bb.parent_layout(max_insert)
    parents = rng.integers(0, 16, (50, band)).astype(np.uint8)
    words = bb.pack_parents(parents, max_insert)
    assert words.shape == (50, 32) and words.nbytes == 50 * row_bytes
    j = int(rng.integers(0, band))
    assert ((int(words[7, j // cells]) >> (4 * (j % cells))) & 15
            == parents[7, j])
    back = bb.unpack_parents(words, max_insert)
    assert np.array_equal(back[:, :band], parents)
    assert not back[:, band:].any()


def test_sub_batches_budget_counts_packed_parent_bytes():
    """The kernel's budget counts parent_layout's bytes a column: 128 at
    max_insert 100 (201 in the byte-a-cell layout), so a 2 GiB sub-batch
    holds more columns."""
    lens = [2000] * 10
    per_problem = 2000 * bb.parent_layout(100)[1]
    assert bb.sub_batches(lens, 100, False, 3 * per_problem) == [
        (0, 3), (3, 6), (6, 9), (9, 10)]
    assert bb.sub_batches(lens, 100, False, 3 * per_problem - 1) == [
        (0, 2), (2, 4), (4, 6), (6, 8), (8, 10)]
    assert bb.sub_batches(lens, 100, False, bb.PARENT_BUDGET) == [(0, 10)]
    assert bb.PARENT_BUDGET // bb.parent_layout(100)[1] > \
        bb.PARENT_BUDGET // 201
