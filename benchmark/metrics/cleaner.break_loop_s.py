"""Seconds a call of the chainCleaner engine's break loop (its phase
`break_loop`, engines/chain_cleaner.py), mean over the window's calls."""

PHASES = ("break_loop",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
