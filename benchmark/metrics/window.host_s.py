"""Host seconds a call of the window path (ops/window_rescore.py): the
phases `rescore: chunk blocks`, `rescore: chunks to device` and `rescore:
check + launch`, mean over the window's calls."""

PHASES = ("rescore: chunk blocks",
          "rescore: chunks to device",
          "rescore: check + launch")


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
