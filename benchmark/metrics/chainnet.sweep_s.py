"""Seconds a call of the chainNet engine's phase `chainnet: net sweep`
(engines/chain_net.py: the native net sweep of both sides,
native/netsweep.cpp), mean over the window's calls."""

PHASES = ("chainnet: net sweep",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
