"""Frozen workload generators, one file each, found by the `generator` of a
configuration file.  Each has `generate(seed, params, out_dir) -> dict`."""
