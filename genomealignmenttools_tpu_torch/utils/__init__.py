"""Host utilities of the port: profiling.py (torch.profiler, the phase
timers) and its own copies of the reference's verbose, bigmem, kenthash,
pipeline and bench_workload."""
