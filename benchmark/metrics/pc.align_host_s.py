"""Seconds a patchChain call outside the band batch: the call's wall time
less every `band: *` phase (ops/band_batch.py), which leaves the engine's
input and output and the gap aligner's seeding, HSP scan and gapped finish
(engines/drivers.py patch_chain, engines/repeat_filler.py, ops/
seed_extend.py); mean over the calls.  None where the call has no root
phase `patchchain`."""


def read(run):
    if run.phases is None or not run.calls or "patchchain" not in run.phases:
        return None
    band = [v for k, v in run.phases.items() if k.startswith("band: ")]
    return (sum(run.calls) - sum(band)) / len(run.calls)
