"""The port's phase spans, with their times.

The port sums each phase's seconds into a dict while an accumulation is on
(`utils/profiling.phase_acc_start`); `phase` and `phase_add` add at the
phase's end.  PhaseRecorder stands in for that dict and notes each addition
as an interval [end - seconds, end] on the monotonic clock, so idle time on
the card can be named by the phase the host was in."""

from __future__ import annotations

import time


class PhaseRecorder(dict):
    def __init__(self):
        super().__init__()
        self.intervals: list[tuple[str, float, float]] = []

    def __setitem__(self, name, total):
        now = time.monotonic()
        self.intervals.append((name, now - (total - self.get(name, 0.0)),
                               now))
        super().__setitem__(name, total)


def start():
    """Turn the port's accumulation on, into a recorder."""
    from genomealignmenttools_tpu_torch.utils import profiling
    profiling.phase_acc_start()
    rec = PhaseRecorder()
    profiling._phase_acc = rec
    return rec


def stop(rec: PhaseRecorder) -> PhaseRecorder:
    from genomealignmenttools_tpu_torch.utils import profiling
    got = profiling.phase_acc_stop()
    if got is not rec:
        raise RuntimeError("the port's phase accumulator was replaced "
                           "during the window")
    return rec
