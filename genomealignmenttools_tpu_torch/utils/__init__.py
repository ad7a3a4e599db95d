"""Host utilities of the port (profiling.py); the jax-free utilities of the
reference (verbose, bench_workload, pipeline) are imported as they are."""
