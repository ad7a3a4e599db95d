"""Seconds a call of the chainCleaner engine's netting and break finding
(its phase `net+find_breaks`), mean over the window's calls."""

PHASES = ("net+find_breaks",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
