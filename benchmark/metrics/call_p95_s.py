"""The 95th percentile of one call's wall seconds over all of the window's
calls (inclusive quantiles)."""

import statistics


def read(run):
    if len(run.calls) < 2:
        return None
    return statistics.quantiles(run.calls, n=100, method="inclusive")[94]
