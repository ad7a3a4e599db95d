"""Seconds a call of the chaining of each gap's HSPs: the phase
`rf: chain` (engines/repeat_filler.py `_gap_job_chains`: axtChain and
chainSort), mean over the window's calls."""

PHASES = ("rf: chain",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
