"""Seconds a call of the gap aligner's seeding: the phase `rf: seed`
(engines/repeat_filler.py: each gap's regions and ops/seed_extend.py
`GapAligner.align_seed`, over a chunk of gaps), mean over the window's
calls."""

PHASES = ("rf: seed",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
