"""Seconds a call of patchChain's seeding: the phase `pc: seed`
(engines/drivers.py patch_chain through engines/repeat_filler.py
`_gap_jobs_hsps`: each gap's regions, its masked seed codes and
ops/seed_extend.py `GapAligner.align_seed`, over a chunk of gaps), mean
over the window's calls."""

PHASES = ("pc: seed",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
