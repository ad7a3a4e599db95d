"""The card's activity over the measured window, from torch.profiler.

The profiler (CUPTI) records every kernel, copy and set on the card; its
Chrome trace is read back and put on the host's monotonic clock by a mark
(a record_function range) taken at a known monotonic time.  From it:
busy seconds (the union of the card's operations in the window), seconds
by operation name, and the idle time named by the host phase open during
it (the innermost one; lib/spans)."""

from __future__ import annotations

import json
import os
import time

MARK = "gat-benchmark-clock-mark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, trace_path: str):
        self.trace_path = trace_path
        self.ops: list[tuple[str, float, float]] = []   # name, start, end
        self._prof = None
        self._marks: list[float] = []

    def _mark(self):
        import torch
        t = time.monotonic()
        with torch.profiler.record_function(MARK):
            pass
        self._marks.append(t)

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._mark()
        self._prof.__exit__(*exc)
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._read()
        os.remove(self.trace_path)
        return False

    def _read(self):
        with open(self.trace_path) as f:
            events = json.load(f)["traceEvents"]
        marks = sorted(e["ts"] for e in events
                       if e.get("name") == MARK and e.get("ph") == "X")
        if len(marks) != len(self._marks):
            raise RuntimeError(f"found {len(marks)} clock marks in the "
                               f"trace, made {len(self._marks)}")
        # profiler microseconds -> monotonic seconds, from the first mark
        off = self._marks[0] - marks[0] * 1e-6
        self.clock_drift_s = (marks[-1] * 1e-6 + off) - self._marks[-1]
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                t0 = e["ts"] * 1e-6 + off
                self.ops.append((e["name"], t0, t0 + e.get("dur", 0) * 1e-6))

    def within(self, w0: float, w1: float):
        return [(n, max(a, w0), min(b, w1)) for n, a, b in self.ops
                if b > w0 and a < w1]

    def busy_s(self, w0: float, w1: float) -> float:
        busy, end = 0.0, w0
        for _, a, b in sorted(self.within(w0, w1), key=lambda o: o[1]):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    def seconds_by_name(self, w0: float, w1: float) -> dict:
        out: dict = {}
        for n, a, b in self.within(w0, w1):
            out[n] = out.get(n, 0.0) + (b - a)
        return out

    def idle_by_phase(self, w0: float, w1: float, phases, calls) -> dict:
        """Idle seconds of the card in [w0, w1], each piece named by the
        innermost phase open (`phases`: (name, start, end)), else
        '(in a call, no phase)' inside a call (`calls`: (start, end)), else
        '(between calls)'."""
        spans = [(a, b, n) for n, a, b in phases] + \
                [(a, b, None) for a, b in calls]
        busy = []                       # the union, as disjoint intervals
        for _, a, b in sorted(self.within(w0, w1), key=lambda o: o[1]):
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        cuts = {w0, w1}
        for a, b, _ in spans:
            cuts.update(x for x in (a, b) if w0 < x < w1)
        for a, b in busy:
            cuts.update((a, b))
        cuts = sorted(c for c in cuts if w0 <= c <= w1)
        out: dict = {}
        bi = 0
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            while bi < len(busy) and busy[bi][1] <= mid:
                bi += 1
            if bi < len(busy) and busy[bi][0] <= mid:
                continue
            best = None
            for a, b, n in spans:
                if a <= mid < b and (best is None
                                     or b - a < best[1] - best[0]):
                    best = (a, b, n)
            name = ("(between calls)" if best is None else
                    best[2] or "(in a call, no phase)")
            out[name] = out.get(name, 0.0) + (hi - lo)
        return out


def idle_pct(run):
    """The share of the traced window in which no operation ran on the
    card (kernels, copies and sets), in %; None without a trace."""
    if run.trace is None or run.w1 <= run.w0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(run.w0, run.w1)
                    / (run.w1 - run.w0))
