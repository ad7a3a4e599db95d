"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Set-up (`setup_s`, from the process's start): the port's libraries
(built into the port's `build/` on a checkout's first run), the cell's
workload made from the seed into the temporary directory, the CUDA context,
and the warm-up: one call on the cell's inputs (`first_call_s`: the genomes
decoded and uploaded, the first launches).  Then the window: whole calls
back to back until `--seconds` have passed.  After the window the peak device
memory is read, the port's state is freed and every distinct output of the
calls is judged by the plain reference (benchmark/reference/).  With
`--trace 1` the window runs under torch.profiler and with the port's phase
spans recorded, and the line carries the per-layer metrics, the card's busy
seconds and a breakdown; with `--trace 0` the end-to-end metrics.

The last line on stdout is one JSON object: correct, attempted (calls),
failed, metrics, device, [breakdown,] checks (each number compared with its
limit).  The same numbers end stderr.  Exit codes: 0 with a result (correct
or not); 2 bad arguments or an unknown cell; 3 no CUDA or too few cards;
4 jax, jaxlib, flax or the JAX package was loaded.  Without the port beside
BENCHMARK.json the import fails and nothing is printed on stdout.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse        # noqa: E402
import gc              # noqa: E402
import hashlib         # noqa: E402
import json            # noqa: E402
import os              # noqa: E402
import shutil          # noqa: E402
import statistics      # noqa: E402
import sys             # noqa: E402
import tempfile        # noqa: E402
import traceback       # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

from benchmark.lib.manifest import Manifest   # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "genomealignmenttools_tpu")
KEEP_DISTINCT = 4          # distinct outputs kept for the reference
TOP = 10                   # entries of each breakdown list


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Record:
    """What one run measured; the metric readers read it."""

    def __init__(self, units: dict):
        self.units = units
        self.setup_s = None
        self.first_call_s = None
        self.calls: list[float] = []
        self.calls_at: list[tuple[float, float]] = []
        self.phases = None
        self.intervals: list = []
        self.trace = None
        self.w0 = self.w1 = 0.0


def set_env(env: dict) -> None:
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)


def digest(paths: list[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            for block in iter(lambda: f.read(1 << 22), b""):
                h.update(block)
        h.update(b"\0")
    return h.hexdigest()


class Outputs:
    """Keeps one copy of each distinct output of the calls (by digest) for
    the reference; more than KEEP_DISTINCT distinct outputs fail the run."""

    def __init__(self, keep_dir: str):
        self.keep_dir = keep_dir
        self.kept: dict[str, list[str]] = {}
        self.calls_of: dict[str, int] = {}
        self.overflow = 0

    def add(self, paths: list[str]) -> None:
        d = digest(paths)
        self.calls_of[d] = self.calls_of.get(d, 0) + 1
        if d in self.kept:
            return
        if len(self.kept) >= KEEP_DISTINCT:
            self.overflow += 1
            return
        dst = os.path.join(self.keep_dir, str(len(self.kept)))
        os.makedirs(dst)
        self.kept[d] = [shutil.copy(p, dst) for p in paths]


def judge(check, workload, config, limits, outputs: Outputs):
    """(numbers, wrong_calls): each number compared, its worst value over
    the distinct outputs, beside its limit; the calls whose output broke
    a limit."""
    worst: dict = {}
    wrong = 0
    for d, paths in outputs.kept.items():
        bad = False
        for name, value in check.check(workload, config, paths):
            value = float(value)
            limit = limits.get(name)
            if limit is None or value > limit:
                bad = True
            if name not in worst or value > worst[name]:
                worst[name] = value
        wrong += outputs.calls_of[d] if bad else 0
    numbers = {n: {"value": v, "limit": limits.get(n)}
               for n, v in worst.items()}
    if outputs.overflow:
        numbers[f"distinct_outputs_over_{KEEP_DISTINCT}"] = {
            "value": outputs.overflow, "limit": 0}
    return numbers, wrong


def breakdown(rec: Record) -> dict:
    ops = sorted(rec.trace.seconds_by_name(rec.w0, rec.w1).items(),
                 key=lambda kv: -kv[1])[:TOP]
    idle = sorted(rec.trace.idle_by_phase(rec.w0, rec.w1, rec.intervals,
                                          rec.calls_at).items(),
                  key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def main(argv=None, device: str | None = None) -> int:
    """`device` is for the CPU tests of the harness: None (the command
    line) means the card, and a run without one exits 3."""
    try:
        args = parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    man = Manifest(ROOT)
    try:
        cell = man.cell(args.workload)
    except KeyError as e:
        log(str(e))
        return 2
    config = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])

    set_env(traffic.get("env", {}))
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
            return 3
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    from genomealignmenttools_tpu_torch.native import get_lib
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    set_verbosity(0)
    t0 = time.monotonic()
    get_lib()
    if on_card:
        from genomealignmenttools_tpu_torch._build import load_library
        load_library()
    log(f"libraries {time.monotonic() - t0:.3f} s")

    work = os.path.join(tempfile.gettempdir(), "gat-benchmark",
                        args.workload)
    shutil.rmtree(work, ignore_errors=True)
    try:
        return run_cell(args, man, cell, config, traffic, dev, on_card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_cell(args, man, cell, config, traffic, dev, on_card, work) -> int:
    import torch
    gen = man.module("workloads", config["generator"])
    t0 = time.monotonic()
    workload = gen.generate(args.seed, config["params"],
                            os.path.join(work, "in"))
    log(f"workload {time.monotonic() - t0:.3f} s")
    rec = Record(workload["units"])
    if on_card:
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out_dir = os.path.join(work, "out")
    os.makedirs(out_dir)
    call = man.module("entries", traffic["entry"]).prepare(
        workload, config, traffic, dev, out_dir)
    outputs = Outputs(os.path.join(work, "kept"))

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    failed = 0
    t0 = time.monotonic()
    try:
        paths = call()
        sync()
    except Exception:
        traceback.print_exc()
        failed += 1
        paths = None
    rec.first_call_s = time.monotonic() - t0
    rec.setup_s = time.monotonic() - T_START
    log(f"{args.workload}: set-up {rec.setup_s:.3f} s, of it the first "
        f"call {rec.first_call_s:.3f} s")
    if paths:
        outputs.add(paths)

    trace = recorder = None
    if args.trace:
        from benchmark.lib import spans
        if on_card:
            from benchmark.lib.devtrace import DeviceTrace
            trace = DeviceTrace(os.path.join(work, "trace.json"))
            trace.__enter__()
        recorder = spans.start()
    deadline = time.monotonic() + args.seconds
    try:
        while True:
            t0 = time.monotonic()
            try:
                paths = call()
                sync()
            except Exception:
                traceback.print_exc()
                failed += 1
                paths = None
            t1 = time.monotonic()
            rec.calls.append(t1 - t0)
            rec.calls_at.append((t0, t1))
            if paths:
                outputs.add(paths)
            if t1 >= deadline:
                break
    finally:
        if recorder is not None:
            spans.stop(recorder)
            rec.phases = dict(recorder)
            rec.intervals = recorder.intervals
        if trace is not None:
            trace.__exit__(None, None, None)
            rec.trace = trace
            log(f"trace clock marks drift {trace.clock_drift_s:.6f} s")
    rec.w0, rec.w1 = rec.calls_at[0][0], rec.calls_at[-1][1]
    log(f"{args.workload}: {len(rec.calls)} calls in "
        f"{rec.w1 - rec.w0:.3f} s, a call "
        f"min {min(rec.calls):.4f} median {statistics.median(rec.calls):.4f}"
        f" max {max(rec.calls):.4f} s")

    if on_card:
        memory_peak = int(max(torch.cuda.max_memory_allocated(i)
                              for i in range(cell["chips"])))
    else:
        memory_peak = 0
    del call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    check = man.module("reference", traffic["check"])
    numbers, wrong = judge(check, workload, config, traffic["limits"],
                           outputs)
    failed += wrong
    attempted = 1 + len(rec.calls)
    correct = (failed == 0 and bool(outputs.kept)
               and all(n["limit"] is not None and n["value"] <= n["limit"]
                       for n in numbers.values()))

    metrics = {}
    for m in man.metrics(args.workload, per_layer=bool(args.trace)):
        value = man.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if on_card else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": memory_peak}}
    if rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s(rec.w0, rec.w1)
        result["device"]["window_s"] = rec.w1 - rec.w0
        result["breakdown"] = breakdown(rec)
    result["checks"] = numbers
    # last, once every reader has run: any of them may have loaded one
    foreign = foreign_modules()
    if foreign:
        log(f"loaded modules that must not be: {foreign}")
        return 4
    print(f"correct {correct} attempted {attempted} failed {failed}",
          file=sys.stderr)
    for name, n in numbers.items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
