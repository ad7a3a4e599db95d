"""The check for jax, jaxlib, flax and the JAX package compares each loaded
module's top-level name whole: the port's name begins with the JAX
package's and must pass."""

import subprocess
import sys

import pytest

from benchmark import run

from conftest import REPO


@pytest.mark.parametrize("name,flagged", [
    ("jax", "jax"), ("jax.numpy", "jax"), ("jaxlib.xla_client", "jaxlib"),
    ("flax.linen", "flax"),
    ("genomealignmenttools_tpu", "genomealignmenttools_tpu"),
    ("genomealignmenttools_tpu.ops.rescore", "genomealignmenttools_tpu"),
    ("genomealignmenttools_tpu_torch", None),
    ("genomealignmenttools_tpu_torch.ops.rescore", None),
    ("jaxtyping", None), ("flaxen", None),
])
def test_top_level_names_whole(monkeypatch, name, flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert run.foreign_modules() == ([flagged] if flagged else [])


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import run, readings\n"
            "from benchmark.reference import cleaner, scorechain, "
            "repeatfiller\n"
            "from benchmark.workloads import cleaner as c, repeatfiller as r\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'genomealignmenttools_tpu', "
            "'genomealignmenttools_tpu_torch')]\n"
            "print(bad)\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
