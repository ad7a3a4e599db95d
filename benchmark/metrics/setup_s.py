"""Seconds from the process's start to the end of the warm-up: libraries
loaded (built on a checkout's first run), the workload made from the seed,
the CUDA context made, and one call on the cell's inputs (the genomes
decoded and uploaded, the first launches)."""


def read(run):
    return run.setup_s
