"""Fixtures of the harness's CPU tests: a copy of the benchmark at small
sizes, and a runner of run.py's main on the CPU in a subprocess."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SMALL = {"chainpair-planted-loose": {"n_scenarios": 12, "n_bulk": 100},
         "gapfill-planted-loose": {"n_gaps": 6}}

_RUN = """
import runpy, sys
mod = runpy.run_path(sys.argv[1], run_name="benchmark_run")
sys.exit(mod["main"](sys.argv[2:], device="cpu"))
"""


def make_copy(dst: str) -> str:
    """BENCHMARK.json and benchmark/ copied to dst, each configuration cut
    to SMALL."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    for c in man["configs"]:
        path = os.path.join(dst, c["file"])
        cfg = json.load(open(path))
        cfg["params"] = SMALL[c["name"]]
        with open(path, "w") as f:
            json.dump(cfg, f)
    return dst


@pytest.fixture
def small_copy(tmp_path):
    return make_copy(str(tmp_path))


def run_cpu(root: str, cell: str, seed: int = 2 ** 33 + 7,
            seconds: float = 0.5, trace: int = 0, env=None):
    """(returncode, result or None, stderr) of run.py's main on the CPU in
    a subprocess, from the copy at root."""
    e = dict(os.environ, PYTHONPATH=REPO, TMPDIR=os.path.join(root, "tmp"))
    e.update(env or {})
    os.makedirs(e["TMPDIR"], exist_ok=True)
    p = subprocess.run(
        [sys.executable, "-c", _RUN, os.path.join(root, "benchmark", "run.py"),
         "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)],
        cwd=root, env=e, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else None
    return p.returncode, result, p.stderr
