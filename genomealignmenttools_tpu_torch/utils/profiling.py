"""Tracing and timing on the port's device.

Counterpart of genomealignmenttools_tpu/utils/profiling.py, whose `trace` is
jax.profiler.trace (profiling.py:73-96):

- `trace(out_dir, device)` - torch.profiler over a region: CPU activity,
  and CUDA activity (CUPTI: every kernel on the card, the port's K1, K2 and
  K3 among them) when the run's device is CUDA; on exit a Chrome trace
  (chrome://tracing, Perfetto) is written into the directory.  Enabled by
  the port CLI's -profile=dir or GAT_PROFILE=dir; a no-op without either.
- `phase(name)` - a host wall-clock span: "name: N millis" at verbosity 2,
  summed into the accumulation (`phase_acc_start`/`phase_acc_stop`) when
  opened on the thread that started it, and a `record_function` range of
  the same name on the profiler's timeline while torch.profiler records,
  so a trace shows each phase beside the kernels it launched.

`phase_add`, `phase_acc_stop`, `set_profile_dir` and `profile_dir` are the
reference's text (profiling.py:24-59); `phase_acc_start` also notes the
thread that starts the accumulation.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from ..device import resolve_device
from .verbose import verbose, verbosity

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
    global _phase_acc, _phase_owner
    _phase_owner = threading.get_ident()
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


_phase_owner: int | None = None     # the thread of phase_acc_start


@contextlib.contextmanager
def phase(name: str, level: int = 2):
    """Wall-clock phase timer: 'name: N millis' at the given verbosity.

    Adds to the accumulation only on the thread that started it, so a
    helper thread's phases never overlap the main thread's; logs from any
    thread.  While torch.profiler records, the phase is also a
    record_function range named `name`."""
    with (torch.profiler.record_function(name)
          if torch.autograd._profiler_enabled()
          else contextlib.nullcontext()):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            if _phase_acc is not None \
                    and threading.get_ident() == _phase_owner:
                _phase_acc[name] = _phase_acc.get(name, 0.0) + dt
            if verbosity() >= level:
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
