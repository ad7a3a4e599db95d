"""The plain reference: NumPy and the standard library only.

It imports nothing of the port and nothing of the JAX package, and takes
nothing the port made: it scores from the genome codes and the plan that
the benchmark's generator made, and reads the port's output files only to
judge them.  One module a check, found by the `check` of a traffic file:
`check(workload, config, outputs) -> [(name, value)]` (each number's
limit is in the traffic file) and
`control(workload, config, out_dir, dtype) -> outputs`, the reference put in
the program's place at a lower precision."""
