"""Milliseconds a call of K3 (band_ext_kernel) on the card, from the
trace."""

KERNEL = "band_ext_kernel"


def read(run):
    if run.trace is None or not run.calls:
        return None
    secs = sum(v for k, v in run.trace.seconds_by_name(run.w0, run.w1).items()
               if KERNEL in k)
    return 1e3 * secs / len(run.calls) if secs > 0 else None
