"""Sizes of the harness's CPU tests for configurations that `tests/conftest.py`
does not list: chainnet-planted-loose holds the chain file of
chainpair-planted-loose, so it runs at that configuration's small size."""

SMALL_AS = {"chainnet-planted-loose": "chainpair-planted-loose"}


def pytest_plugin_registered(plugin):
    small = getattr(plugin, "SMALL", None)
    if isinstance(small, dict):
        for name, like in SMALL_AS.items():
            if like in small:
                small.setdefault(name, dict(small[like]))
