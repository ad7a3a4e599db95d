"""Seconds a call of the chainNet engine's phase `chainnet: write`
(engines/chain_net.py: both nets written, the query side on a second thread
inside it), mean over the window's calls."""

PHASES = ("chainnet: write",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
