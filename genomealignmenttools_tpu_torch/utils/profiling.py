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

The phase timers and the profile directory (`phase`, `phase_add`,
`phase_acc_start`/`phase_acc_stop`, `set_profile_dir`, `profile_dir`) are
the reference's text (profiling.py:24-70).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..device import resolve_device
from .verbose import verbose

_profile_dir: str | None = None


def set_profile_dir(path: str | None) -> None:
    global _profile_dir
    _profile_dir = path


def profile_dir() -> str | None:
    return _profile_dir if _profile_dir is not None \
        else (os.environ.get("GAT_PROFILE") or None)


_phase_acc: dict | None = None


def phase_acc_start() -> None:
    """Begin accumulating phase() durations (bench phase breakdowns)."""
    global _phase_acc
    _phase_acc = {}


def phase_acc_stop() -> dict:
    """Stop accumulating; returns {phase_name: seconds}."""
    global _phase_acc
    acc, _phase_acc = _phase_acc, None
    return acc or {}


def phase_add(name: str, seconds: float) -> None:
    """Record a phase duration measured by the caller (no-op unless a
    phase accumulation is active)."""
    if _phase_acc is not None:
        _phase_acc[name] = _phase_acc.get(name, 0.0) + seconds


@contextlib.contextmanager
def phase(name: str, level: int = 2):
    """Wall-clock phase timer: 'name: N millis' at the given verbosity."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        if _phase_acc is not None:
            _phase_acc[name] = _phase_acc.get(name, 0.0) + dt
        verbose(level, "%s: %d millis\n" % (name, int(dt * 1000)))



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
