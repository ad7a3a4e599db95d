"""Tracing and timing on the port's device.

Counterpart of genomealignmenttools_tpu/utils/profiling.py, whose `trace` is
jax.profiler.trace and whose `device_timer` waits with
jax.block_until_ready (profiling.py:73-96):

- `trace(out_dir, device)` - torch.profiler over a region: CPU activity,
  and CUDA activity (CUPTI: every kernel on the card, the port's K1, K2 and
  K3 among them) when the run's device is CUDA; on exit a Chrome trace
  (chrome://tracing, Perfetto) is written into the directory.  Enabled by
  the port CLI's -profile=dir or GAT_PROFILE=dir; a no-op without either.
- `device_timer(fn, ...)` - (result, seconds), synchronising the CUDA
  devices of the result before the clock stops.

The phase timers and the profile directory are the reference's own
(re-exported below), so the directory is one piece of global state for both
CLIs.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from genomealignmenttools_tpu.utils.profiling import (  # noqa: F401
    phase, phase_acc_start, phase_acc_stop, phase_add, profile_dir,
    set_profile_dir)
from genomealignmenttools_tpu.utils.verbose import verbose

from ..device import resolve_device


@contextlib.contextmanager
def trace(out_dir: str | None = None,
          device: str | torch.device | None = None):
    """torch.profiler trace of the region into out_dir (default: the
    profile directory), as trace.<pid>.<ns>.json; no-op when neither is
    set.  `device` is the run's device (default cuda, which raises without
    CUDA): CUDA activity is traced when it is a card."""
    target = out_dir or profile_dir()
    if not target:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        target, f"trace.{os.getpid()}.{time.time_ns()}.json"))
    verbose(1, "profiler trace written to %s\n" % target)


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def device_timer(fn, *args, sync=True, **kwargs):
    """Run fn(*args, **kwargs) and return (result, seconds); with sync, the
    clock stops after torch.cuda.synchronize on every CUDA device of the
    result's tensors (nested in tuples, lists and dicts)."""
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    if sync:
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
    return out, time.monotonic() - t0
