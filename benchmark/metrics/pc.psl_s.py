"""Seconds a call of patchChain's output: the phase `pc: axt + psl`
(engines/drivers.py patch_chain: the axt records in job order, the
identity/entropy filter, axtToPsl and the psl write), mean over the
window's calls."""

PHASES = ("pc: axt + psl",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
