"""Seconds of the warm-up call, the first on the cell's inputs in a fresh
process: the genomes decoded and uploaded to the card, the first launches;
a part of setup_s."""


def read(run):
    return run.first_call_s
