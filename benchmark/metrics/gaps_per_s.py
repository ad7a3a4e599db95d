"""Gap jobs run, times the window's calls, over the calls' summed wall
seconds."""


def read(run):
    if "gaps" not in run.units or not run.calls:
        return None
    return run.units["gaps"] * len(run.calls) / sum(run.calls)
