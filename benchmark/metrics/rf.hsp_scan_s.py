"""Seconds a call of the gap aligner's HSP scan: the phase `rf: hsp scan`
(ops/seed_extend.py `GapAligner.align_scan`, the native scan of the seed
windows, over a chunk of gaps), mean over the window's calls."""

PHASES = ("rf: hsp scan",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
