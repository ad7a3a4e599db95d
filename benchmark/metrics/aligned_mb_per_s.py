"""Mb of aligned chain bases in the input file, times the window's calls,
over the calls' summed wall seconds."""


def read(run):
    if "aligned_bases" not in run.units or not run.calls:
        return None
    return run.units["aligned_bases"] * len(run.calls) / sum(run.calls) / 1e6
