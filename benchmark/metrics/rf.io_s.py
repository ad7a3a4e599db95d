"""Seconds a call of RepeatFiller's input and output: the phases
`rf: read + harvest` (the chain file read, the filters, the gap harvest,
the aligner's set-up) and `rf: splice + write` (engines/repeat_filler.py),
mean over the window's calls."""

PHASES = ("rf: read + harvest", "rf: splice + write")


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
