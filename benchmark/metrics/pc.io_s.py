"""Seconds a call of patchChain's input and output: the phases
`pc: read + harvest` (the chain file read, the gap harvest, the genomes'
and their masks' loading, the aligner's set-up) and `pc: axt + psl` (the
axt records, the filters and the psl writer; engines/drivers.py
patch_chain), mean over the window's calls."""

PHASES = ("pc: read + harvest", "pc: axt + psl")


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
