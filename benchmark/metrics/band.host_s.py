"""Host seconds a call of the band batch (ops/band_batch.py): the phases
`band: orient`, `band: pack + to device` and `band: moves to symbols`,
mean over the window's calls."""

PHASES = ("band: orient",
          "band: pack + to device",
          "band: moves to symbols")


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
