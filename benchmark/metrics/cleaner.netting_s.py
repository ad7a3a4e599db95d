"""Seconds a call of the chainCleaner engine's in-memory netting, inside
`net+find_breaks`: the phase `cleaner: net` (engines/chain_cleaner.py: the
net of the input chains and, off the fused path, its non-nested filter),
mean over the window's calls."""

PHASES = ("cleaner: net",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
