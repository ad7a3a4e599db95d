"""Seconds a call of the chainNet engine's phase `chainnet: parse`
(engines/chain_net.py: the chain file read into the port's chain table and
checked for score order), mean over the window's calls."""

PHASES = ("chainnet: parse",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
