"""The port's profiler: -profile=dir on the port CLI, trace and device_timer.

On the CPU the trace holds CPU activity only; the scoreChain output under
the profiler must stay byte-identical to the golden.
"""

import json
import os

import pytest
import torch

from genomealignmenttools_tpu_torch.cli.main import main as port_main
from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.utils import profiling


@pytest.fixture
def no_profile_dir(monkeypatch):
    """The profile directory is process-wide: leave it unset after the
    test, whatever the CLI set."""
    monkeypatch.delenv("GAT_PROFILE", raising=False)
    yield
    profiling.set_profile_dir(None)


def test_profile_flag_writes_trace_and_keeps_output(fixtures_dir, golden_dir,
                                                    tmp_path, no_profile_dir):
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    out, prof = str(tmp_path / "s.chain"), str(tmp_path / "prof")
    perf_reset()
    assert port_main(["scoreChain", f("synthetic.chain"), f("target.2bit"),
                      f("query.2bit"), out, "-linearGap=loose",
                      "-profile=" + prof, "-device=cpu"]) == 0
    assert PERF["dispatches"] > 0
    with open(out, "rb") as a, open(os.path.join(
            golden_dir, "scoreChain.loose.chain"), "rb") as b:
        assert a.read() == b.read()
    assert profiling.profile_dir() == prof
    (name,) = os.listdir(prof)
    with open(os.path.join(prof, name)) as fh:
        events = json.load(fh)["traceEvents"]
    # the plain chunk sums ran inside the traced window
    assert any(e.get("name") == "aten::index_add_" for e in events)


def test_trace_is_a_noop_without_a_directory(tmp_path, no_profile_dir):
    with profiling.trace(device="cpu"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert os.listdir(tmp_path) == []
    with profiling.trace(str(tmp_path / "t"), device="cpu"):
        torch.ones(3).sum()
    assert len(os.listdir(tmp_path / "t")) == 1


def test_device_timer_returns_result_and_time():
    out, secs = profiling.device_timer(lambda a, b=1: (a + b, [a]),
                                       torch.tensor([2]), b=3)
    assert torch.equal(out[0], torch.tensor([5])) and secs >= 0.0
    out, secs = profiling.device_timer(sum, [1, 2], sync=False)
    assert out == 3 and secs >= 0.0
