"""K4's plain version and the chunk-wide HSP scan of the gap aligner, on
the CPU.

`ops/hsp_scan.hsp_best` gives each scan window's best segment score (K4 on
the card, `hsp_best_plain` here); `GapAligner.align_scan_batch` scores every
window of a chunk of gaps at once on the aligner's band device and splits
only the windows that reach K.
Here the plain version is held to a numpy Kadane and to `_max_segments` on
the edge cases of tests/hsp_cases.py, and the chunk-wide scan, with the
plain version in K4's place, to the host scan gap by gap, at both
gap-filling cells' generators and configurations.
"""

import numpy as np
import pytest
import torch

import hsp_cases as hc
from genomealignmenttools_tpu_torch.device import LAUNCHES, PERF, perf_reset
from genomealignmenttools_tpu_torch.ops import hsp_scan as hs
from genomealignmenttools_tpu_torch.ops.seed_extend import _max_segments
from genomealignmenttools_tpu_torch.utils import profiling

LUT = torch.from_numpy(hc.hsp_lut().astype(np.int32))
N_GAPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: under the parallel test runner, torch's
    intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def edge():
    return hc.edge_case()


def _plain(t, q, t_start, q_start, length, lut=LUT):
    return hs.hsp_best(*(torch.from_numpy(a) for a in (t, q)), lut,
                       *(torch.from_numpy(a) for a in (t_start, q_start,
                                                       length))).numpy()


def test_plain_matches_numpy_kadane_and_max_segments(edge):
    t, q, t_start, q_start, length = edge
    lut = hc.hsp_lut()
    perf_reset()
    got = _plain(*edge)
    assert not any(LAUNCHES.values())
    want = hc.kadane(*edge, lut)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # the edge cases are there: every length, negative bests, exactly K
    assert set(hc.LENGTHS) <= set(length.tolist())
    assert (want < 0).sum() >= 5 and (want == hc.K).sum() >= 2
    assert ((want < hc.K) & (want > hc.K - 10)).sum() >= 2
    for w in range(length.size):
        ts, qs, n = t_start[w], q_start[w], length[w]
        segs = _max_segments(lut[q[qs:qs + n], t[ts:ts + n]], hc.K)
        if want[w] >= hc.K:
            assert max(s[2] for s in segs) == want[w]
        else:
            assert segs == []


@pytest.mark.parametrize("cells", [1, 600, 5001])
def test_plain_version_in_batches(edge, monkeypatch, cells):
    """The plain version expands PLAIN_CELLS cells at a time (at least one
    window a batch): every cut gives the same bests."""
    monkeypatch.setattr(hs, "PLAIN_CELLS", cells)
    assert np.array_equal(_plain(*edge), hc.kadane(*edge, hc.hsp_lut()))


def test_wrapper_refuses_what_k4_does_not_take(edge):
    t, q, t_start, q_start, length = (torch.from_numpy(a) for a in edge)
    ok = (t, q, LUT, t_start, q_start, length)

    def call(**kw):
        args = dict(zip(("t", "q", "lut", "ts", "qs", "ln"), ok), **kw)
        return hs.hsp_best(*args.values())
    with pytest.raises(TypeError):
        call(ln=length.to(torch.int64))
    with pytest.raises(ValueError):
        call(lut=LUT[:4, :4].contiguous())
    with pytest.raises(ValueError):
        call(t=torch.cat([t, torch.tensor([5], dtype=torch.uint8)]))
    with pytest.raises(IndexError):
        call(ts=t_start + t.numel())
    with pytest.raises(IndexError):
        call(ln=torch.zeros_like(length))
    with pytest.raises(ValueError):
        call(qs=q_start[:3])
    long = torch.zeros(hs.MAX_WINDOW + 1, dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="too long"):
        hs.hsp_best(long, long, LUT, one, one,
                    torch.tensor([hs.MAX_WINDOW + 1], dtype=torch.int32))
    # within the cells, but cells * max|lut| reaches 2^28
    with pytest.raises(ValueError, match="too long"):
        hs.hsp_best(long, long, LUT * 3, one, one,
                    torch.tensor([hs.MAX_WINDOW], dtype=torch.int32))
    empty = torch.zeros(0, dtype=torch.int32)
    assert hs.hsp_best(t, q, LUT, t_start[:0], q_start[:0], empty).numel() == 0


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """One small chunk of each gap-filling cell, as its tool seeds it
    (patchchain.gaps masked and unmasked)."""
    out = {}
    for cell, unmask in (("patchchain.gaps", False), ("patchchain.gaps", True),
                         ("repeatfiller.gaps", False)):
        d = tmp_path_factory.mktemp(cell.replace(".", "_"))
        out[cell, unmask] = hc.cell_chunk(cell, str(d), 2500000007, N_GAPS,
                                          "cpu", unmask=unmask)
    return out


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("cell,unmask", [("patchchain.gaps", False),
                                         ("patchchain.gaps", True),
                                         ("repeatfiller.gaps", False)])
def test_align_scan_batch_equals_align_scan(chunks, monkeypatch, cell, unmask,
                                            native):
    """Every gap's HSP rows, in order, the same through the chunk-wide scan
    (the plain version in K4's place on the CPU band device; the exact split
    native or in numpy, GAT_HSP_NATIVE) as through the host scan gap by
    gap; a gap whose region was too large stays None."""
    monkeypatch.setenv("GAT_HSP_NATIVE", native)
    aligner, seeded = chunks[cell, unmask]
    seeded = seeded + [None]
    want = [None if s is None else aligner.align_scan(s) for s in seeded]
    assert sum(len(w) for w in want if w) > N_GAPS   # rows to compare
    perf_reset()
    assert aligner.align_scan_batch(seeded) == want
    windows = sum(s[4][0].size for s in seeded if s is not None)
    assert PERF["hsp_windows_device"] == windows
    assert PERF["hsp_windows_host"] == 0
    assert 0 < PERF["hsp_windows_exact"] <= windows
    # without a band device (GAT_BAND=host) the host scan, gap by gap
    monkeypatch.setattr(aligner, "device", None)
    perf_reset()
    assert aligner.align_scan_batch(seeded) == want
    assert PERF["hsp_windows_host"] == windows
    assert PERF["hsp_windows_device"] == PERF["hsp_windows_exact"] == 0


def test_counters_and_phases_of_the_chunk_wide_scan(chunks):
    """The windows split on the host are those whose best reaches K, no
    more than the windows scanned; the stage's time is in its two phases."""
    aligner, seeded = chunks["patchchain.gaps", False]
    perf_reset()
    profiling.phase_acc_start()
    with profiling.phase("pc: hsp scan"):
        aligner.align_scan_batch(seeded)
    phases = profiling.phase_acc_stop()
    reach = 0
    for s in seeded:
        t_region, q_region, _, _, (diag, w0, w1), _ = s
        best = hc.kadane(t_region, q_region, w0, w0 - diag,
                         (w1 - w0).astype(np.int32), aligner.hsp_lut)
        reach += int((best >= aligner.hsp_threshold).sum())
    assert PERF["hsp_windows_exact"] == reach
    assert PERF["hsp_windows_exact"] <= (PERF["hsp_windows_device"]
                                         + PERF["hsp_windows_host"])
    assert set(phases) == {"pc: hsp scan", "hsp: to device",
                           "hsp: exact segments"}
    assert phases["hsp: to device"] + phases["hsp: exact segments"] \
        <= phases["pc: hsp scan"]
