"""Seconds a call of the scorer's native combine (the phase `rescore:
native combine`, ops/rescore.py), mean over the window's calls."""

PHASES = ("rescore: native combine",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
