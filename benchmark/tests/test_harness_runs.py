"""Whole runs of run.py on the CPU, at small sizes, in a copy of the
benchmark: every cell proves correct; a cell, configuration, traffic mix
and metric added as files alone are found by name; the control and each
fault a cell can have, planted under the timed path, come out as not
correct; without a card or without the port nothing is printed."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, make_copy, run_cpu

CELLS = ["cleaner.window", "repeatfiller.gaps"]
# A cell whose files stay in the benchmark but which BENCHMARK.json does not
# list (its runs spread too widely between processes for a bound): the
# tests list it in their copy, as a later change would, and run it too.
SHELVED = {"scorechain.window": (
    {"config": "chainpair-planted-loose", "traffic": "scorechain-window",
     "chips": 1, "why": "scoreChain back to back"},
    ["aligned_mb_per_s", "call_p95_s", "scorer.combine_s", "window.host_s",
     "device.idle_pct.rescore"])}


def listed(root, cell):
    """The cell, listed in the copy's BENCHMARK.json if it is shelved."""
    if cell in SHELVED:
        entry, metrics = SHELVED[cell]
        man_path = os.path.join(root, "BENCHMARK.json")
        man = json.load(open(man_path))
        man["workloads"].append(dict(entry, name=cell))
        for m in man["end_to_end"] + man["per_layer"]:
            if m["name"] in metrics:
                m["workloads"].append(cell)
        with open(man_path, "w") as f:
            json.dump(man, f)
    return cell

# An entry that wraps the cell's own entry and breaks what it produces:
#   control    the check's control (the reference in the program's place,
#              at the configuration's control precision) replaces the output
#   unchanged  the step returns its state unchanged: the input, no BED line
#   half       half of the batch left out: the tool runs on the first half
#              of the chains, or the second half of the gaps keeps no fill
#   altered    an answer altered where it is produced: one score + 1, or
#              the longest added block moved one base along the target
#   truncated  (RepeatFiller) each fill cut after the gap's first planted
#              piece, as an extension stopping at the first indel leaves it
FAULT_ENTRY = '''
import os, shutil
import numpy as np
from benchmark.lib.manifest import Manifest
from benchmark.reference.common import read_chains, write_chains

def prepare(workload, config, traffic, device, out_dir):
    man = Manifest(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    kind, of = traffic["fault"], traffic["of"]
    real = man.module("entries", of)
    p = workload["paths"]
    if kind == "half":
        half = dict(workload, paths=dict(p, chain=p["chain"] + ".half"))
        chains = read_chains(p["chain"])
        if len(chains) > 1:
            write_chains(half["paths"]["chain"], chains[:len(chains) // 2])
        else:
            half = workload
        call = real.prepare(half, config, traffic, device, out_dir)
    else:
        call = real.prepare(workload, config, traffic, device, out_dir)
    check = man.module("reference", traffic["check"])

    def broken():
        outs = call()
        if kind == "control":
            dtype = config.get("control_precision")
            got = check.control(workload, config, out_dir,
                                np.dtype(dtype).type if dtype else None)
            for src, dst in zip(got, outs):
                shutil.copy(src, dst)
        elif kind == "truncated":
            shutil.copy(check.faults(workload, out_dir, outs)["truncated"][0],
                        outs[0])
        elif kind == "unchanged":
            shutil.copy(p["chain"], outs[0])
            for o in outs[1:]:
                open(o, "w").close()
        elif kind == "half" and len(workload["chains"]) == 1:
            c = read_chains(outs[0])[0]
            anchors = workload["chains"][0]["blocks"]
            cut = anchors[len(anchors) // 2]
            b = c["blocks"]
            keep = (b[:, 0] < cut[0]) | np.isin(
                b[:, 0], anchors[:, 0]) & np.isin(b[:, 2], anchors[:, 2])
            write_chains(outs[0], [dict(c, blocks=b[keep])])
        elif kind == "altered":
            chains = read_chains(outs[0])
            if len(chains) > 1:
                chains[0]["score"] += 1
            else:       # the longest added block, one base along t
                b = chains[0]["blocks"]
                anchors = workload["chains"][0]["blocks"]
                added = ~np.isin(b[:, 0], anchors[:, 0])
                i = np.flatnonzero(added)[np.argmax(
                    (b[:, 1] - b[:, 0])[added])]
                b[i, :2] += 1
            write_chains(outs[0], chains)
        return outs
    return broken
'''


def add_fault_cell(root, cell, fault):
    man_path = os.path.join(root, "BENCHMARK.json")
    man = json.load(open(man_path))
    w = next(x for x in man["workloads"] if x["name"] == cell)
    traffic = json.load(open(os.path.join(root, "benchmark", "traffic",
                                          w["traffic"] + ".json")))
    name = f"{w['traffic']}-{fault}"
    traffic.update(entry="fault", of=traffic["entry"], fault=fault)
    with open(os.path.join(root, "benchmark", "traffic", name + ".json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "benchmark", "entries", "fault.py"),
              "w") as f:
        f.write(FAULT_ENTRY)
    new = dict(w, name=f"{cell}.{fault}", traffic=name)
    man["workloads"].append(new)
    with open(man_path, "w") as f:
        json.dump(man, f)
    return new["name"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS + list(SHELVED))
def test_cell_is_correct(small_copy, cell, trace):
    # long enough for two calls on a loaded CPU: call_p95_s needs two
    rc, res, err = run_cpu(small_copy, listed(small_copy, cell), seconds=6,
                           trace=trace)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    man = json.load(open(os.path.join(small_copy, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]}
    got = set(res["metrics"])
    if trace:        # no card here: the trace's metrics find nothing
        want = {m for m in want if not ("roofline" in m or "device" in m)}
    assert got == want
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(ln.startswith("check ") for ln in tail)


@pytest.mark.parametrize("fault", ["control", "unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS + list(SHELVED))
def test_fault_is_not_correct(small_copy, cell, fault):
    name = add_fault_cell(small_copy, listed(small_copy, cell), fault)
    rc, res, err = run_cpu(small_copy, name)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
    assert res["failed"] == res["attempted"]


def test_truncated_fill_is_not_correct(small_copy):
    """Fills that stop at the first indel score above the threshold, lie
    on the homolog and move no block: only the share of the homolog they
    miss catches them."""
    name = add_fault_cell(small_copy, "repeatfiller.gaps", "truncated")
    rc, res, err = run_cpu(small_copy, name)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
    bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert bad == {"homolog_missed_pct"}


def test_a_reader_that_loads_jax_leaves_no_result(small_copy, tmp_path):
    """A metric reader, found by name after the window, that imports a
    module named jax: the run exits 4 and prints nothing on stdout."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    root = small_copy
    with open(os.path.join(root, "benchmark", "metrics",
                           "new.loads_jax.py"), "w") as f:
        f.write("import jax  # noqa: F401\n\n\ndef read(run):\n"
                "    return 1.0\n")
    man_path = os.path.join(root, "BENCHMARK.json")
    man = json.load(open(man_path))
    man["per_layer"].append({"name": "new.loads_jax", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "a test", "moves": "aligned_mb_per_s",
                             "workloads": ["cleaner.window"]})
    json.dump(man, open(man_path, "w"))
    rc, res, err = run_cpu(root, "cleaner.window", seconds=1, trace=1,
                           env={"PYTHONPATH": REPO + os.pathsep + str(stub)})
    assert rc == 4 and res is None, err[-3000:]
    assert "['jax']" in err


def test_new_files_are_found_by_name(small_copy):
    """A configuration, a traffic mix, a metric and a cell, each a new file
    or a new entry of BENCHMARK.json; no file of the harness edited."""
    root = small_copy
    bench = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(bench, "configs",
                                      "chainpair-planted-loose.json")))
    cfg.update(name="newpair-loose", params={"n_scenarios": 5, "n_bulk": 50})
    json.dump(cfg, open(os.path.join(bench, "configs", "newpair-loose.json"),
                        "w"))
    shutil.copy(os.path.join(bench, "traffic", "scorechain-window.json"),
                os.path.join(bench, "traffic", "scorechain-again.json"))
    with open(os.path.join(bench, "metrics", "new.calls_n.py"), "w") as f:
        f.write("def read(run):\n    return len(run.calls)\n")
    man_path = os.path.join(root, "BENCHMARK.json")
    man = json.load(open(man_path))
    man["configs"].append({"name": "newpair-loose", "source": "a test",
                           "file": "benchmark/configs/newpair-loose.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "new.cell", "config": "newpair-loose",
                             "traffic": "scorechain-again", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "new.calls_n", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "a test", "moves": "aligned_mb_per_s",
                             "workloads": ["new.cell"]})
    for m in man["end_to_end"]:
        if m["name"] in ("aligned_mb_per_s", "call_p95_s"):
            m["workloads"].append("new.cell")
    json.dump(man, open(man_path, "w"))
    rc, res, err = run_cpu(root, "new.cell", seconds=2, trace=1)
    assert rc == 0 and res["correct"], err[-3000:]
    assert res["metrics"]["new.calls_n"]["value"] >= 1
    rc, res, err = run_cpu(root, "new.cell", seconds=2, trace=0)
    assert rc == 0 and res["correct"], err[-3000:]
    assert set(res["metrics"]) == {"aligned_mb_per_s", "call_p95_s",
                                   "setup_s"}


def _cli(root, env):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cleaner.window",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=root,
        env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result(small_copy):
    """The command line wants the card: without CUDA it exits 3 and prints
    nothing on stdout."""
    p = _cli(small_copy, dict(os.environ, PYTHONPATH=REPO,
                              CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 3 and p.stdout == ""


def test_without_the_port_no_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/: the port is
    not there, the run fails and prints nothing."""
    root = make_copy(str(tmp_path))
    code = ("import runpy, sys; m = runpy.run_path('benchmark/run.py', "
            "run_name='x'); sys.exit(m['main'](['--workload', "
            "'cleaner.window', '--seed', '5', '--seconds', '1', "
            "'--trace', '0'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "genomealignmenttools_tpu_torch" in p.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """Each cell briefly, at its own size, through the command line."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 32 + 11), "--seconds", "3", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
