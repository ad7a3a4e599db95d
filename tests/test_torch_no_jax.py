"""The port never imports jax.

tests/conftest.py imports jax into every test process, so each check runs
the port's CLI on the CPU in a fresh interpreter and then asserts that
neither jax nor a module of the JAX package that needs it (pair_rescore,
the Pallas kernels, among them pallas_band, the jax-backed rescore paths)
was loaded.  The outputs are byte-compared with the goldens on the way
(patchChain has none: it is held against the reference in
tests/test_torch_gap_fill.py); scoreChain with -profile must also write its
trace.
"""

import os
import subprocess
import sys

import pytest

from conftest import hermetic_cpu_env

_SCRIPT = r"""
import os, sys
fix, gold, out, tool = sys.argv[1:5]
from genomealignmenttools_tpu_torch.cli.main import main
from genomealignmenttools_tpu_torch.device import PERF
f = lambda n: os.path.join(fix, n)
o = lambda n: os.path.join(out, n)
runs = {
    "scoreChain": (["scoreChain", f("synthetic.chain"), f("target.2bit"),
                    f("query.2bit"), o("s.chain"), "-linearGap=loose"],
                   [("s.chain", "scoreChain.loose.chain")]),
    "chainNetRescore": (
        ["chainNet", f("synthetic.scored.sorted.chain"),
         f("target.chrom.sizes"), f("query.chrom.sizes"), o("t.net"),
         o("q.net"), "-rescore", "-tNibDir=" + f("target.2bit"),
         "-qNibDir=" + f("query.2bit"), "-linearGap=loose"],
        [("t.net", "chainNetRescore.target.net"),
         ("q.net", "chainNetRescore.query.net")]),
    "chainCleaner": (
        ["chainCleaner", f("synthetic.scored.sorted.chain"),
         f("target.2bit"), f("query.2bit"), o("c.chain"), o("c.bed"),
         "-tSizes=" + f("target.chrom.sizes"),
         "-qSizes=" + f("query.chrom.sizes"), "-linearGap=loose",
         "-verbose=0"],
        [("c.chain", "chainCleaner.out.chain"),
         ("c.bed", "chainCleaner.removedSuspects.bed")]),
    "RepeatFiller": (
        ["RepeatFiller", "-c", f("repeatfiller_input.chain"),
         "-T2", f("target.2bit"), "-Q2", f("query.2bit"), "-o", o("rf.chain"),
         "--refQuirks"],
        [("rf.chain", "repeatfiller_reference_output.chain")]),
    "patchChain": (
        ["patchChain", f("repeatfiller_input.chain"), f("target.2bit"),
         f("query.2bit"), f("target.chrom.sizes"), f("query.chrom.sizes"),
         o("p.psl"), "-unmask"], []),
    "FilterChainsNetFilterNets": (
        ["FilterChainsNetFilterNets", f("synthetic.scored.sorted.chain"),
         f("cleaner_input.net"), o("fc.chain"), o("fc.net"),
         f("target.2bit"), f("query.2bit"), f("target.chrom.sizes"),
         f("query.chrom.sizes"), "-minScore=50000,200000",
         "-minSizeT=1000,0", "-minSizeQ=1000,0"],
        [("fc.chain", "filterChains.filtered.chain"),
         ("fc.net", "filterChains.filtered.net")]),
    "scoreChainProfile": (
        ["scoreChain", f("synthetic.chain"), f("target.2bit"),
         f("query.2bit"), o("s.chain"), "-linearGap=loose",
         "-profile=" + o("prof")],
        [("s.chain", "scoreChain.loose.chain")]),
}
argv, pairs = runs[tool]
if main(argv + ["-device=cpu"]) != 0:
    sys.exit("cli failed")
if PERF["dispatches"] == 0:
    sys.exit("the port's scorer was not used")
if argv[0] in ("RepeatFiller", "patchChain") and PERF["band_problems"] == 0:
    sys.exit("the port's band batch was not used")
if tool == "scoreChainProfile" and not os.listdir(o("prof")):
    sys.exit("-profile wrote no trace")
for got, want in pairs:
    if open(o(got), "rb").read() != open(os.path.join(gold, want), "rb").read():
        sys.exit(f"{got} differs from {want}")
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m.startswith("genomealignmenttools_tpu.ops.pa")
                or m == "genomealignmenttools_tpu.parallel.mesh")
print("LOADED", loaded)
"""


def _run(fixtures_dir, golden_dir, tmp_path, tool, **env):
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, fixtures_dir, golden_dir,
         str(tmp_path), tool],
        env={**hermetic_cpu_env(), **env}, capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(fixtures_dir))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout[-3000:]


@pytest.mark.parametrize("tool", ["scoreChain", "chainNetRescore",
                                  "chainCleaner", "RepeatFiller",
                                  "patchChain", "FilterChainsNetFilterNets",
                                  "scoreChainProfile"])
def test_port_cli_runs_without_jax(fixtures_dir, golden_dir, tmp_path, tool):
    _run(fixtures_dir, golden_dir, tmp_path, tool)


@pytest.mark.parametrize("tool", ["scoreChain", "chainNetRescore",
                                  "chainCleaner"])
def test_port_cli_pair_mode_runs_without_jax(fixtures_dir, golden_dir,
                                             tmp_path, tool):
    """Pair mode loads neither jax nor the reference's pair_rescore or
    pallas_combine (both import jax)."""
    _run(fixtures_dir, golden_dir, tmp_path, tool, GAT_RESCORE="pair",
         GAT_COMBINE="device")
