"""K1 of the PyTorch port (ops/window_rescore.py) against the JAX reference.

The same numpy-seeded blocks go through the port's plain version on the CPU,
the JAX PallasBlockScorer in interpret mode (ops/pallas_rescore.py, tiny WB
as tests/test_device_rescore.py sets it) and the host engines.scoring sums.
All of it is integer math, so every comparison is exact.  The CUDA kernel
itself is compared with the plain version on a card, in
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

from genomealignmenttools_tpu.device.genome import revcomp_codes
from genomealignmenttools_tpu.engines.scoring import block_scores
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops import pallas_rescore
from genomealignmenttools_tpu.ops.rescore import DeviceGenomeCache
from genomealignmenttools_tpu_torch.ops import window_rescore as wr
from genomealignmenttools_tpu_torch.ops.rescore import TorchGenomeCache
from rescore_cases import LENGTHS, alignment_case, direct_sums

LUT = np.asarray(score_scheme_default().lut)
CPU = torch.device("cpu")


class _Genome:
    """Genome stand-in over seeded code arrays; codes() returns the same
    array object on every call, as device/genome.py's cache does."""

    def __init__(self, seqs: dict):
        self._plus = seqs
        self._minus = {k: revcomp_codes(v) for k, v in seqs.items()}

    def codes(self, name, strand="+"):
        return self._plus[name] if strand == "+" else self._minus[name]


def _codes(rng, size):
    codes = rng.integers(0, 4, size).astype(np.uint8)
    for s in rng.integers(0, size, 12):        # N runs
        codes[s:s + int(rng.integers(1, 300))] = 4
    return codes


def _job_blocks(rng, n, t_size, q_size, max_len=700, max_gap=6000):
    """Colinear blocks: lengths up to max_len (many > CHUNK), gaps large
    enough that a job spans several 16 kb windows."""
    t, q, rows = int(rng.integers(0, 1000)), int(rng.integers(0, 1000)), []
    for _ in range(n):
        ln = int(rng.integers(1, max_len))
        if t + ln > t_size or q + ln > q_size:
            break
        rows.append((t, t + ln, q, q + ln))
        t += ln + int(rng.integers(0, max_gap))
        q += ln + int(rng.integers(0, max_gap))
    return np.array(rows, np.int64).reshape(-1, 4)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1234)
    t_gen = _Genome({"tA": _codes(rng, 120_000), "tB": _codes(rng, 40_000)})
    q_gen = _Genome({"qA": _codes(rng, 150_000), "qB": _codes(rng, 30_000)})
    jobs = [
        ("tA", "qA", "+", _job_blocks(rng, 40, 120_000, 150_000)),
        ("tA", "qA", "-", _job_blocks(rng, 40, 120_000, 150_000)),
        ("tB", "qB", "+", _job_blocks(rng, 12, 40_000, 30_000, 300, 500)),
        ("tB", "qA", "-", np.zeros((0, 4), np.int64)),           # empty job
        ("tB", "qB", "-", np.array([[39_000, 40_000, 29_000, 30_000]],
                                   np.int64)),                # genome ends
    ]
    return t_gen, q_gen, jobs


@pytest.fixture(scope="module")
def pallas_chunk_scores(case):
    t_gen, q_gen, jobs = case
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_rescore, "WB", 16)
    try:
        scorer = pallas_rescore.PallasBlockScorer(
            LUT, DeviceGenomeCache(t_gen), DeviceGenomeCache(q_gen))
        multi = scorer.chunk_scores_multi(jobs)
        per_job = [scorer.block_scores(*job) for job in jobs]
    finally:
        mp.undo()
    return multi, per_job


def _port(case):
    t_gen, q_gen, _ = case
    return wr.WindowBlockScorer(LUT, TorchGenomeCache(t_gen, CPU),
                                TorchGenomeCache(q_gen, CPU))


def test_jobs_span_several_windows_and_chunks(case):
    _, _, jobs = case
    blocks = jobs[0][3]
    assert blocks[-1, 1] - blocks[0, 0] > 3 * pallas_rescore.WIN
    assert (blocks[:, 1] - blocks[:, 0]).max() > wr.CHUNK


def test_chunk_scores_multi_matches_pallas(case, pallas_chunk_scores):
    """Same chunks, same chunk -> block map, same int32 sums."""
    (cs_j, cb_j, nb_j), _ = pallas_chunk_scores
    cs, cb, nb = _port(case).chunk_scores_multi(case[2])
    assert nb == nb_j
    assert cs.dtype == np.int32 and np.array_equal(cs, cs_j)
    assert np.array_equal(cb, cb_j)


@pytest.mark.parametrize("job", range(5))
def test_block_scores_match_pallas_and_host(case, pallas_chunk_scores, job):
    t_gen, q_gen, jobs = case
    tn, qn, strand, blocks = jobs[job]
    got = _port(case).block_scores(tn, qn, strand, blocks)
    host = block_scores(blocks, t_gen.codes(tn, "+"),
                        q_gen.codes(qn, strand), LUT)
    assert got.dtype == np.int64
    assert np.array_equal(got, pallas_chunk_scores[1][job])
    assert np.array_equal(got, host)


def test_chunk_blocks_matches_pack_windows():
    blocks = np.array([[0, 0, 5, 5], [10, 11, 20, 21], [100, 612, 0, 512],
                       [700, 956, 600, 856], [1000, 1257, 900, 1157]],
                      np.int64)
    t_off, q_off, length, c_block = wr.chunk_blocks(blocks)
    assert c_block.tolist() == pallas_rescore.pack_windows(blocks)[4].tolist()
    assert length.tolist() == [0, 1, 256, 256, 256, 256, 1]
    assert t_off.tolist() == [0, 10, 100, 356, 700, 1000, 1256]
    assert q_off.tolist() == [5, 20, 0, 256, 600, 900, 1156]


def _loop_sums(t, q, t_off, q_off, length):
    lut = LUT.astype(np.int64)
    out = []
    for to, qo, ln in zip(t_off, q_off, length):
        s = 0
        for i in range(ln):
            tc, qc = int(t[to + i]), int(q[qo + i])
            s += int(lut[qc, tc]) if tc < 4 and qc < 4 else 0
        out.append(s)
    return out


def _edge_chunks(rng, t_len=5000, q_len=4000, n=64):
    t, q = _codes(rng, t_len), _codes(rng, q_len)
    length = rng.integers(0, wr.CHUNK + 1, n).astype(np.int32)
    length[:4] = [0, 1, 255, 256]
    t_off = rng.integers(0, t_len - wr.CHUNK, n).astype(np.int64)
    q_off = rng.integers(0, q_len - wr.CHUNK, n).astype(np.int64)
    t_off[3], q_off[3] = t_len - 256, q_len - 256   # ends at the genome end
    t_off[0], q_off[0] = t_len, q_len               # empty, at the end
    return t, q, t_off, q_off, length


def test_plain_matches_loop_on_edge_chunks():
    arrs = _edge_chunks(np.random.default_rng(5))
    got = wr.chunk_sums(*[torch.from_numpy(a) for a in arrs[:2]],
                        wr.checked_lut(LUT),
                        *[torch.from_numpy(a) for a in arrs[2:]])
    assert got.dtype == torch.int32
    assert got.tolist() == _loop_sums(*arrs)


def _args():
    t, q, t_off, q_off, length = (torch.from_numpy(a) for a in
                                  _edge_chunks(np.random.default_rng(6)))
    return dict(t_codes=t, q_codes=q, lut=wr.checked_lut(LUT), t_off=t_off,
                q_off=q_off, length=length)


@pytest.mark.parametrize("change,exc", [
    (lambda a: a.update(t_codes=a["t_codes"].to(torch.int32)), TypeError),
    (lambda a: a.update(length=a["length"].to(torch.int64)), TypeError),
    (lambda a: a.update(q_off=a["q_off"].reshape(8, 8)), ValueError),
    (lambda a: a.update(t_off=torch.stack([a["t_off"]] * 2, 1)[:, 0]),
     ValueError),                                      # not contiguous
    (lambda a: a.update(length=a["length"][:10]), ValueError),
    (lambda a: a.update(lut=a["lut"][:4, :4]), ValueError),
    (lambda a: a.update(t_codes=a["t_codes"].to("meta")), ValueError),
    (lambda a: a["t_off"].__setitem__(1, a["t_codes"].numel()), IndexError),
    (lambda a: a["q_off"].__setitem__(2, -1), IndexError),
    (lambda a: a["length"].__setitem__(5, wr.CHUNK + 1), IndexError),
], ids=["codes-dtype", "length-dtype", "2d", "strided", "lengths-differ",
        "lut-shape", "mixed-device", "t-past-end", "q-negative",
        "chunk-too-long"])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, exc):
    a = _args()
    change(a)
    with pytest.raises(exc):
        wr.chunk_sums(**a)


def test_wrapper_refuses_unsupported_device():
    a = {k: v.to("meta") if k != "lut" else v for k, v in _args().items()}
    with pytest.raises(ValueError, match="no rescore path"):
        wr.chunk_sums(**a)


def test_checked_lut_needs_zero_n_row_and_int8():
    bad = LUT.copy()
    bad[4, 0] = -100
    with pytest.raises(ValueError, match="zero N"):
        wr.checked_lut(bad)
    big = LUT.astype(np.int64)
    big[0, 0] = 300
    with pytest.raises(ValueError, match="int8"):
        wr.checked_lut(big)


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_version_on_every_alignment(length):
    """The case set K1's 16-byte loads are held on (every (t_off mod 16,
    q_off mod 16) pair, chunks that end at a genome's last byte), through
    the plain version on the CPU against the definition, one length at a
    time."""
    t, q, t_off, q_off, ln = alignment_case()
    keep = ln == length
    assert keep.sum() >= 256 + 48
    pairs = {(int(a) % 16, int(b) % 16) for a, b in zip(t_off[keep],
                                                        q_off[keep])}
    assert len(pairs) == 256
    assert (t_off[keep] + length == t.shape[0]).any()
    assert (q_off[keep] + length == q.shape[0]).any()
    lut = wr.checked_lut(score_scheme_default().lut)
    got = wr.chunk_sums(torch.from_numpy(t), torch.from_numpy(q), lut,
                        *[torch.from_numpy(a[keep]) for a in (t_off, q_off,
                                                              ln)])
    want = direct_sums(t, q, lut.numpy(), t_off[keep], q_off[keep], ln[keep])
    assert np.array_equal(got.numpy().astype(np.int64), want)


def test_plain_version_any_byte_is_n():
    """A code >= 4, whatever the byte, scores 0 (K1 flags any such byte)."""
    t, q, t_off, q_off, ln = alignment_case()
    rng = np.random.default_rng(3)
    t, q = t.copy(), q.copy()
    for codes in (t, q):
        at = rng.integers(0, codes.shape[0], 3000)
        codes[at] = rng.integers(4, 256, at.shape[0]).astype(np.uint8)
    lut = wr.checked_lut(score_scheme_default().lut)
    got = wr.chunk_sums(torch.from_numpy(t), torch.from_numpy(q), lut,
                        *[torch.from_numpy(a) for a in (t_off, q_off, ln)])
    assert np.array_equal(got.numpy().astype(np.int64),
                          direct_sums(t, q, lut.numpy(), t_off, q_off, ln))
