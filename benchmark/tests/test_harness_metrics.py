"""The metric readers on a recorded run: phase totals, call times and a
Chrome trace of the card, put on the host's clock by the clock marks."""

import json
import os

import pytest

from benchmark.lib.counts import k1_bytes
from benchmark.lib.devtrace import MARK, DeviceTrace
from benchmark.lib.manifest import Manifest
from benchmark.lib.spans import PhaseRecorder

from conftest import REPO

MAN = Manifest(REPO)
RESCORE = "void rescore_chunks_kernel<4>(unsigned char const*)"
BAND = "void (anonymous namespace)::band_ext_kernel<7>(unsigned char const*)"


def recorded_trace(tmp_path) -> DeviceTrace:
    """A trace as torch.profiler writes it: profiler microseconds, two
    clock marks taken at monotonic 100.0 s and 102.0 s."""
    base = 5_000_000.0                       # profiler us at monotonic 100 s
    ev = [{"ph": "X", "cat": "user_annotation", "name": MARK, "ts": base,
           "dur": 1},
          {"ph": "X", "cat": "user_annotation", "name": MARK,
           "ts": base + 2e6, "dur": 1},
          # 1 ms of K1 at 100.5 s, 1 ms of K1 at 101.5 s, 2 ms of K3 and a
          # 0.5 ms copy overlapping it at 101.0 s
          {"ph": "X", "cat": "kernel", "name": RESCORE, "ts": base + 5e5,
           "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": RESCORE, "ts": base + 1.5e6,
           "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": BAND, "ts": base + 1e6,
           "dur": 2000},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": base + 1e6 + 1000, "dur": 1500},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": base,
           "dur": 50}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = DeviceTrace(str(path))
    tr._marks = [100.0, 102.0]
    tr._read()
    return tr


class Run:
    def __init__(self, trace=None, phases=None):
        self.setup_s, self.first_call_s = 12.5, 1.25
        self.calls = [0.5, 0.7, 0.6, 0.9]
        self.calls_at = [(100.0, 100.5), (100.5, 101.2), (101.2, 101.8),
                         (101.8, 102.7)]
        self.w0, self.w1 = 100.0, 102.7
        self.units = {"aligned_bases": 137_000_000, "blocks": 434_000,
                      "chains": 34_000, "gaps": 600}
        self.phases = phases
        self.trace = trace


def read(name, run):
    return MAN.module("metrics", name).read(run)


def test_trace_on_the_host_clock(tmp_path):
    tr = recorded_trace(tmp_path)
    assert tr.clock_drift_s == pytest.approx(0.0, abs=1e-9)
    assert tr.busy_s(100.0, 102.7) == pytest.approx(0.0045)   # 1+1+2.5 ms
    by = tr.seconds_by_name(100.0, 102.7)
    assert by[RESCORE] == pytest.approx(0.002)
    assert by[BAND] == pytest.approx(0.002)


def test_end_to_end_readers():
    run = Run()
    assert read("setup_s", run) == 12.5
    assert read("first_call_s", run) == 1.25
    assert read("aligned_mb_per_s", run) == pytest.approx(137 * 4 / 2.7)
    assert read("gaps_per_s", run) == pytest.approx(600 * 4 / 2.7)
    # inclusive quantiles of 0.5 0.6 0.7 0.9: the 95th lies 0.85 of the
    # way from 0.7 to 0.9
    assert read("call_p95_s", run) == pytest.approx(0.87)
    run.units = {}
    assert read("aligned_mb_per_s", run) is None


def test_phase_readers():
    ph = {"break_loop": 1.2, "net+find_breaks": 0.8, "read chains": 0.4,
          "rescore: native combine": 0.04, "rescore: chunk blocks": 0.2,
          "rescore: chunks to device": 0.04, "rescore: check + launch": 0.02,
          "rescore: wait + sums to host": 0.1, "band: orient": 0.1,
          "band: pack + to device": 0.2, "band: DP + fetch": 0.3,
          "band: moves to symbols": 0.4}
    run = Run(phases=ph)
    assert read("cleaner.break_loop_s", run) == pytest.approx(0.3)
    assert read("cleaner.net_s", run) == pytest.approx(0.2)
    assert read("scorechain.read_s", run) == pytest.approx(0.1)
    assert read("scorer.combine_s", run) == pytest.approx(0.01)
    assert read("window.host_s", run) == pytest.approx(0.065)
    assert read("band.host_s", run) == pytest.approx(0.175)
    assert read("rf.align_host_s", run) == pytest.approx((2.7 - 1.0) / 4)
    assert read("cleaner.break_loop_s", Run(phases={})) is None
    assert read("cleaner.break_loop_s", Run()) is None


def test_trace_readers(tmp_path):
    run = Run(trace=recorded_trace(tmp_path))
    # 2 ms of K1 over 4 calls; the bound of a call at 3.35 TB/s
    bound = k1_bytes(run.units) / 3.35e12
    assert read("k1_roofline", run) == pytest.approx(100 * bound / 0.0005)
    assert read("k3.device_ms", run) == pytest.approx(0.5)
    idle = 100 * (1 - 0.0045 / 2.7)
    assert read("device.idle_pct.rescore", run) == pytest.approx(idle)
    assert read("device.idle_pct.gapfill", run) == pytest.approx(idle)
    assert read("k1_roofline", Run()) is None


def test_idle_named_by_phase(tmp_path):
    tr = recorded_trace(tmp_path)
    phases = [("break_loop", 100.0, 101.0),
              ("rescore: chunk blocks", 100.2, 100.4)]
    calls = [(100.0, 101.2), (101.4, 102.7)]
    idle = tr.idle_by_phase(100.0, 102.7, phases, calls)
    assert idle["rescore: chunk blocks"] == pytest.approx(0.2)
    assert idle["break_loop"] == pytest.approx(0.8 - 0.001)
    assert idle["(between calls)"] == pytest.approx(0.2)
    assert idle["(in a call, no phase)"] == pytest.approx(
        0.2 - 0.0025 + 1.3 - 0.001)
    assert sum(idle.values()) == pytest.approx(2.7 - 0.0045)


def test_phase_recorder_intervals(monkeypatch):
    import time
    now = iter([10.0, 12.0, 15.0])
    monkeypatch.setattr(time, "monotonic", lambda: next(now))
    rec = PhaseRecorder()
    rec["a"] = rec.get("a", 0.0) + 0.5
    rec["b"] = rec.get("b", 0.0) + 1.0
    rec["a"] = rec.get("a", 0.0) + 0.25
    assert rec == {"a": 0.75, "b": 1.0}
    assert rec.intervals == [("a", 9.5, 10.0), ("b", 11.0, 12.0),
                             ("a", 14.75, 15.0)]


def test_every_metric_has_a_reader():
    for kind in ("end_to_end", "per_layer"):
        for m in MAN.data[kind]:
            assert os.path.exists(os.path.join(
                REPO, "benchmark", "metrics", m["name"] + ".py")), m["name"]
