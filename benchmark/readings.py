"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's workload at its own size, one call
of the timed path (the cell's entry, as run.py calls it) judged by the
reference, the control (the reference put in the program's place at the
configuration's control precision) judged the same way, and each fault
that the check plants in the program's output (its `faults`, where it has
one).  One JSON line a seed, then a summary: the largest value of each
number over the program's seeds (its lower reading), the smallest over the
control's (its upper reading) and over each fault's, beside the limit in
the traffic file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

import numpy as np                               # noqa: E402

from benchmark.lib.manifest import Manifest      # noqa: E402
from benchmark.run import set_env                 # noqa: E402


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    man = Manifest(ROOT)
    cell = man.cell(args.workload)
    config = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    set_env(traffic.get("env", {}))
    import torch
    dev = torch.device(device)
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    set_verbosity(0)
    gen = man.module("workloads", config["generator"])
    entry = man.module("entries", traffic["entry"])
    check = man.module("reference", traffic["check"])
    dtype = (np.dtype(config["control_precision"]).type
             if config.get("control_precision") else None)
    lower: dict = {}
    upper: dict = {}
    faults: dict = {}
    base = os.path.join(tempfile.gettempdir(), "gat-benchmark-readings")
    for seed in args.seeds:
        # a directory a seed: the port keeps decoded genomes by path
        work = os.path.join(base, str(seed))
        shutil.rmtree(work, ignore_errors=True)
        try:
            t0 = time.monotonic()
            w = gen.generate(seed, config["params"], os.path.join(work, "in"))
            t1 = time.monotonic()
            os.makedirs(os.path.join(work, "out"))
            call = entry.prepare(w, config, traffic, dev,
                                 os.path.join(work, "out"))
            outs = call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.monotonic()
            prog = dict(check.check(w, config, outs))
            ctrl = dict(check.check(w, config, check.control(
                w, config, work, dtype)))
            planted = (check.faults(w, work, outs)
                       if hasattr(check, "faults") else {})
            fault = {k: dict(check.check(w, config, v))
                     for k, v in planted.items()}
            t3 = time.monotonic()
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for k, v in prog.items():
            lower[k] = max(lower.get(k, float(v)), float(v))
        for k, v in ctrl.items():
            upper[k] = min(upper.get(k, float(v)), float(v))
        for f, nums in fault.items():
            least = faults.setdefault(f, {})
            for k, v in nums.items():
                least[k] = min(least.get(k, float(v)), float(v))
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "faults": fault, "make_s": t1 - t0,
                          "call_s": t2 - t1, "judge_s": t3 - t2},
                         default=float), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": lower, "upper": upper, "faults": faults,
                      "limits": traffic["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
