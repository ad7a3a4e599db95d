"""Seconds a call outside the band batch: the call's wall time less every
`band: *` phase (ops/band_batch.py), which leaves the gap-filling engine
and the gap aligner's seeding, HSP scan, chaining and splicing
(engines/repeat_filler.py, ops/seed_extend.py); mean over the calls."""


def read(run):
    if run.phases is None or not run.calls:
        return None
    band = [v for k, v in run.phases.items() if k.startswith("band: ")]
    if not band:
        return None
    return (sum(run.calls) - sum(band)) / len(run.calls)
