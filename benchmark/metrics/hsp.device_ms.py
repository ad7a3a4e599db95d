"""Milliseconds a call of K4 (hsp_best_kernel, the gap aligner's scan
windows' best segment scores) on the card, from the trace; nothing where
the program launches no K4."""

KERNEL = "hsp_best_kernel"


def read(run):
    if run.trace is None or not run.calls:
        return None
    secs = sum(v for k, v in run.trace.seconds_by_name(run.w0, run.w1).items()
               if KERNEL in k)
    return 1e3 * secs / len(run.calls) if secs > 0 else None
