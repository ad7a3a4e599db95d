"""Seconds a call of the chainNet engine's phase `chainnet: rescore fills`
(engines/chain_net.py: every partial target fill cut from its chain on the
host and all of them scored in one call of the port's scorer, whose
`rescore: *` phases run inside it), mean over the window's calls."""

PHASES = ("chainnet: rescore fills",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
