"""Seconds a call of scoreChain's chain parse (its phase `read chains`,
engines/score_chain.py), mean over the window's calls."""

PHASES = ("read chains",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
