"""The port's benchmark: one cell of BENCHMARK.json run once by run.py.

Everything that belongs to one configuration, traffic mix, entry, check or
metric sits in a file of its own that run.py finds by name (README.md)."""
