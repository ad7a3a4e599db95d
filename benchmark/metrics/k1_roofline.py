"""K1's share of its roofline: the least time the card could take to move
the bytes K1 must move for one call (lib/counts.k1_bytes: every aligned base
of the file once), at the published HBM bandwidth, over the device time of
K1 (rescore_chunks_kernel) a call in the trace; in %."""

from ..lib.counts import k1_bytes
from ..lib.peaks import H100_SXM

KERNEL = "rescore_chunks_kernel"


def read(run):
    if run.trace is None or not run.calls:
        return None
    secs = sum(v for k, v in run.trace.seconds_by_name(run.w0, run.w1).items()
               if KERNEL in k)
    if secs <= 0:
        return None
    bound = k1_bytes(run.units) / H100_SXM["hbm_bytes_per_s"]
    return 100.0 * bound / (secs / len(run.calls))
