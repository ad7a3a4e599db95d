"""Pytest hooks for the whole repository.

The benchmark's CPU tests (benchmark/tests/conftest.py) cut each
configuration of BENCHMARK.json to the small size its SMALL dict names;
SMALL_SIZES adds the sizes of configurations that dict does not list, as
benchmark/conftest.py does for those that share another's size.  The
plugin is found by its file, benchmark/tests/conftest.py."""

import os

SMALL_SIZES = {"patchchain-planted-hoxd55": {"n_gaps": 8}}
HARNESS_CONFTEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "benchmark", "tests", "conftest.py")


def pytest_plugin_registered(plugin):
    path = getattr(plugin, "__file__", None)
    if path is None or os.path.abspath(path) != HARNESS_CONFTEST:
        return
    for name, params in SMALL_SIZES.items():
        plugin.SMALL.setdefault(name, dict(params))
