"""The port never imports jax, nor anything of the JAX package.

tests/conftest.py imports jax into every test process, so each check runs
the port's CLI on the CPU in a fresh interpreter and then asserts that no
module named jax, jax.*, jaxlib*, genomealignmenttools_tpu or
genomealignmenttools_tpu.* was loaded.  The outputs are byte-compared with
the goldens on the way (patchChain has none: it is held against the
reference in tests/test_torch_gap_fill.py); scoreChain with -profile must
also write its trace.  The commands that touch no device run in the port
too: their outputs are byte-compared with the reference CLI's, computed in
the test process.  A static case holds that no file of the port names the
JAX package in an import, nor does chip_smoke.py or a case table it
reads; chip_smoke.py's [variants] child runs here on the CPU without jax.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import hermetic_cpu_env
from genomealignmenttools_tpu.cli.main import main as jax_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what no process that runs only the port may have in sys.modules
_LOADED = r"""
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "genomealignmenttools_tpu"
                or m.startswith("genomealignmenttools_tpu."))
print("LOADED", loaded)
"""

_SCRIPT = r"""
import os, sys
fix, gold, out, tool, mode = sys.argv[1:6]
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
# "cpu": the torch scorer on the CPU; "host": the host-native paths, which
# take no -device and pass no kernel wrapper
if main(argv + (["-device=cpu"] if mode == "cpu" else [])) != 0:
    sys.exit("cli failed")
if mode == "cpu" and PERF["dispatches"] == 0:
    sys.exit("the port's scorer was not used")
if mode == "host" and PERF["dispatches"] != 0:
    sys.exit("a kernel wrapper was passed in the host-native mode")
if (mode == "cpu" and argv[0] in ("RepeatFiller", "patchChain")
        and PERF["band_problems"] == 0):
    sys.exit("the port's band batch was not used")
if tool == "scoreChainProfile" and not os.listdir(o("prof")):
    sys.exit("-profile wrote no trace")
for got, want in pairs:
    if open(o(got), "rb").read() != open(os.path.join(gold, want), "rb").read():
        sys.exit(f"{got} differs from {want}")
""" + _LOADED


def _run(fixtures_dir, golden_dir, tmp_path, tool, mode="cpu", **env):
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, fixtures_dir, golden_dir,
         str(tmp_path), tool, mode],
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
    """Pair mode loads neither jax nor any module of the JAX package."""
    _run(fixtures_dir, golden_dir, tmp_path, tool, GAT_RESCORE="pair",
         GAT_COMBINE="device")


@pytest.mark.parametrize("tool", ["scoreChain", "chainNetRescore",
                                  "chainCleaner"])
def test_port_cli_hostnative_mode_runs_without_jax(fixtures_dir, golden_dir,
                                                   tmp_path, tool):
    """The host-native scorer is the port's own copy: no module of the JAX
    package, no -device, no kernel wrapper."""
    _run(fixtures_dir, golden_dir, tmp_path, tool, mode="host",
         GAT_RESCORE="hostnative")


@pytest.mark.parametrize("tool", ["RepeatFiller", "patchChain"])
def test_port_cli_host_band_batch_runs_without_jax(fixtures_dir, golden_dir,
                                                   tmp_path, tool):
    """GAT_BAND=host: the port's copy of the host band batch (the native
    bandext.cpp), no -device, nothing of the JAX package; RepeatFiller
    still writes the golden."""
    _run(fixtures_dir, golden_dir, tmp_path, tool, mode="host",
         GAT_BAND="host")


def _plain_commands(fix, gold, out):
    """Commands that touch no device, on the fixtures the reference's own
    tests use: (argv, writes to stdout)."""
    f = lambda n: os.path.join(fix, n)  # noqa: E731
    g = lambda n: os.path.join(gold, n)  # noqa: E731
    chain = f("synthetic.scored.sorted.chain")
    return {
        "chainSort": (["chainSort", f("ties.chain"), out], False),
        "chainSortTarget": (["chainSort", f("meta.chain"), out, "-target"],
                            False),
        "chainPreNet": (["chainPreNet", chain, f("target.chrom.sizes"),
                         f("query.chrom.sizes"), out], False),
        "netSyntenic": (["netSyntenic", g("chainNet.target.net"), out],
                        False),
        "NetFilterNonNested": (["NetFilterNonNested", g("chainNet.target.net"),
                                "-minScore1", "3000"], True),
        "chainBridge": (["chainBridge", chain, f("target.2bit"),
                         f("query.2bit"), out], False),
        "axtChain": (["axtChain", "-linearGap=loose", f("sorted.axt"),
                      f("target.2bit"), f("query.2bit"), out], False),
        "chainSwap": (["chainSwap", chain, out], False),
        "chainNet": (["chainNet", chain, f("target.chrom.sizes"),
                      f("query.chrom.sizes"), out, os.devnull], False),
    }


_PLAIN_SCRIPT = r"""
import contextlib, json, sys
argv, out, to_stdout = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
from genomealignmenttools_tpu_torch.cli.main import main
if to_stdout:
    with open(out, "w") as fh, contextlib.redirect_stdout(fh):
        rc = main(argv)
else:
    rc = main(argv)
if rc != 0:
    sys.exit("cli failed")
""" + _LOADED


@pytest.mark.parametrize("tool", ["chainSort", "chainSortTarget",
                                  "chainPreNet", "netSyntenic",
                                  "NetFilterNonNested", "chainBridge",
                                  "axtChain", "chainSwap", "chainNet"])
def test_port_runs_plain_commands_itself(fixtures_dir, golden_dir, tmp_path,
                                         tool):
    """The commands the port used to forward: the port's own copy writes the
    reference CLI's bytes, takes -device and ignores it (the default would
    raise here), and loads nothing of the JAX package."""
    import json
    port_out, ref_out = str(tmp_path / "port.out"), str(tmp_path / "ref.out")
    argv, to_stdout = _plain_commands(fixtures_dir, golden_dir, ref_out)[tool]
    if to_stdout:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jax_main(argv) == 0
        with open(ref_out, "w") as fh:
            fh.write(buf.getvalue())
    else:
        assert jax_main(argv) == 0
    argv, _ = _plain_commands(fixtures_dir, golden_dir, port_out)[tool]
    device = [] if tool == "chainNet" else ["-device=cuda"]
    res = subprocess.run(
        [sys.executable, "-c", _PLAIN_SCRIPT, json.dumps(argv + device),
         port_out, "1" if to_stdout else "0"],
        env=hermetic_cpu_env(), capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(fixtures_dir))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout[-3000:]
    with open(port_out, "rb") as a, open(ref_out, "rb") as b:
        got = a.read()
        assert got == b.read() and got


def test_command_table_is_the_reference_cli_s():
    """All 42 command names of the reference CLI, each run by the port."""
    from genomealignmenttools_tpu.cli.main import COMMANDS as ref_commands
    from genomealignmenttools_tpu_torch.cli import main as port_cli
    assert sorted(port_cli.COMMANDS) == sorted(ref_commands)
    assert len(port_cli.COMMANDS) == 42
    assert port_cli.DEVICE_COMMANDS <= set(port_cli.COMMANDS)
    assert not hasattr(port_cli, "reference_main")
    for name, fn in port_cli.COMMANDS.items():
        assert fn.__module__ == port_cli.__name__, name


def test_no_file_of_the_port_imports_the_jax_package():
    """Static: no file under genomealignmenttools_tpu_torch/, not
    chip_smoke.py and not the case tables it reads (tests/golden_cases.py,
    variant_cases.py) imports jax or genomealignmenttools_tpu (the name
    followed by `.` or a space; genomealignmenttools_tpu_torch is the
    port)."""
    pat = re.compile(r"^\s*(from|import)\s+(genomealignmenttools_tpu|jax|"
                     r"jaxlib)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tests", n) for n in ("golden_cases.py",
                                                 "variant_cases.py")]
    for root, _, names in os.walk(os.path.join(
            REPO, "genomealignmenttools_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    hits = []
    for path in files:
        with open(path) as fh:
            text = fh.read()
        hits += [(os.path.relpath(path, REPO), m.group(0).strip())
                 for m in pat.finditer(text)]
    assert not hits


def test_variants_child_runs_without_jax(tmp_path):
    """chip_smoke.py's [variants] children run variant_cases.run_child in a
    fresh interpreter: here on the CPU, the GAT_NATIVE=0 setting's
    scoreChain rows, which must give the golden and load neither jax nor
    the JAX package."""
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import variant_cases as vc; "
            "print(json.dumps(vc.run_child('native0', '', '', sys.argv[3], "
            "'cpu', ['native0-scoreChain-window', "
            "'native0-scoreChain-pair'])))")
    res = subprocess.run(
        [sys.executable, "-c", code, os.path.join(REPO, "tests"), REPO,
         str(tmp_path)], env={**hermetic_cpu_env(), "GAT_NATIVE": "0"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    payload = json.loads(res.stdout.strip().splitlines()[-1])
    assert payload["foreign"] == []
    assert len(payload["results"]) == 2
    with open(os.path.join(REPO, "tests", "golden",
                           "scoreChain.loose.chain"), "rb") as fh:
        want = hashlib.sha256(fh.read()).hexdigest()
    assert all(r["sha256"] == [want] for r in payload["results"].values())
