"""Host seconds a call of patchChain's gapped stage around the band
batch: the phases `pc: band problems` (the extension problems of each
gap's HSPs) and `pc: gapped finish` (the best-first replay of the
extensions), in ops/seed_extend.py, mean over the window's calls."""

PHASES = ("pc: band problems", "pc: gapped finish")


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
