"""Seconds a call of patchChain's HSP scan: the phase `pc: hsp scan`
(ops/seed_extend.py `GapAligner.align_scan` over a chunk of gaps), mean
over the window's calls."""

PHASES = ("pc: hsp scan",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
