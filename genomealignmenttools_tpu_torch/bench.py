"""The port's bench: chainCleaner at chr1 scale (the headline), chainNet
-rescore, scoreChain, the resident pass and RepeatFiller, run through the
port on one CUDA card beside the port's host-native oracle and, where the
locally built binaries exist, the reference C tools.

    python -m genomealignmenttools_tpu_torch.bench [--device=cuda]
        [--cleaner-scenarios 2000] [--cleaner-bulk 30000]
        [--chr1-size 256000000] [--chr1-chains 384]
        [--rf-gaps 600]

The counterpart of the root bench.py.  It prints ONE json line, last, with
the keys {"metric", "value", "unit", "vs_baseline", "extra"}, within a
global wall-clock budget (GAT_BENCH_BUDGET_S, default 390 s): a watchdog
thread prints what has been measured so far, kills the child process it
finds running and exits.  `extra.sections_done` lists the sections that
finished; a section the budget cut leaves its fields out or null.  Progress
goes to stderr.

Sections, in the order of the root bench.py:

1. cleaner - clean_chains on build_cleaner_workload (2,000 planted break
   scenarios + 30,000 bulk chains): the port on the card in its default mode
   (window: K1) and in pair mode (K2 from int8 tiles, GAT_COMBINE=device),
   and the host-native oracle (GAT_RESCORE=hostnative), each one cold run
   then three warm runs (median, min, max), CPU seconds per warm run, the
   phase split (utils/profiling's phase accumulator, mean over the warm
   runs) and each kernel's launches (deltas of device.LAUNCHES).  C: a live
   run when .ref_build/ holds the binaries (cached for the same boot, as the
   root bench does), else tests/golden/bench_baseline.json, labelled as
   recorded on another machine.  `value` is the port's warm median on the
   card in the default mode; `vs_baseline` is C's seconds over it.
2. chainnet_rescore - chain_net(rescore=True) on the same workload, the
   same modes and fields.
3. scorechain - score_chain_file on build_workload(256 Mb, 384 chains):
   cold and warm seconds and Mb aligned per second in the three modes
   (pair mode's scoreChain takes the torch row sums and the native combine,
   as the reference's does, and launches no hand-written kernel).
4. resident - the same chains through TorchPairChainScorer: set-up (pack,
   upload, metadata), single-pass seconds and the sustained pass
   (T(41) - T(1)) / 40 of score_chained, resident_hbm_bytes and its share
   of the H100's 3.35 TB/s, a null-launch round trip and pinned
   host-to-device GB/s; the host-native scorer's throughput beside it.
5. repeatfiller - the first 600 gap jobs of build_repeatfiller_workload
   (its 3,000 gaps, as the root bench builds it) through _run_gap_jobs and
   the port's GapAligner, once with GAT_BAND=host and once on the card
   (K3): seconds, gaps/s, Mb of gap/s, checksums.
6. cleaner_1thread - the host-native chainCleaner with GAT_THREADS=1 in a
   subprocess of the port (the native library caches its thread count).

Every card output is byte-compared with the host-native run's, and with
C's where C ran.  A difference, a card section that launches no kernel, a
host-native run that launches one, a section that raises, or a module of
jax or of the JAX package in sys.modules is named in `extra.failures`; the
line is printed all the same and the exit code is 1.  Workloads are cached
under GAT_BENCH_DIR (default: gat_bench_torch in the temporary directory),
one directory per workload and size.  `--device=cpu` runs the plain PyTorch
versions of the kernels; it is for the tests, and its times are CPU times.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_PATH = os.path.join(REPO, "tests", "golden", "bench_baseline.json")
REF_BIN = os.path.join(REPO, ".ref_build", "bin")
KENT_BIN = os.path.join(REPO, ".ref_build", "kent", "bin")

MARGIN_S = 12.0          # the watchdog fires this long before the budget ends
WARM_RUNS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 bandwidth
CHAINED_PASSES = 41         # the root bench's sustained protocol, bench.py:500

# the environment of each scoring mode: the port's default (window mode,
# K1), pair mode with the device combine (K2 from int8 tiles) and the
# host-native oracle, which touches no device
MODES = {
    "window": {"GAT_RESCORE": None, "GAT_COMBINE": None,
               "GAT_PAIR_TILES": None},
    "pair": {"GAT_RESCORE": "pair", "GAT_COMBINE": "device",
             "GAT_PAIR_TILES": None},
    "hostnative": {"GAT_RESCORE": "hostnative", "GAT_COMBINE": None,
                   "GAT_PAIR_TILES": None},
}
# the kernel a card mode must launch where the engine scores through
# score_chains (scoreChain's pair mode launches none)
MUST_LAUNCH = {"window": "rescore_chunks", "pair": "pair_combine"}
RF_WORKLOAD_GAPS = 3000     # the root bench's repeatfiller build, bench.py:398
C_RECORDED = ("tests/golden/bench_baseline.json (recorded on another "
              "machine, {})")

_SINGLE_THREAD = r"""
import json, sys, time
from genomealignmenttools_tpu_torch.engines.chain_cleaner import clean_chains
from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
set_verbosity(0)
m, chain, bed, n = json.loads(sys.argv[1])
def once():
    t0 = time.monotonic()
    clean_chains(m["chain"], m["t2bit"], m["q2bit"], chain, bed,
                 t_sizes=m["t_sizes"], q_sizes=m["q_sizes"],
                 linear_gap="loose")
    return time.monotonic() - t0
cold = once()
warm = [once() for _ in range(n)]
from genomealignmenttools_tpu_torch.bench import foreign_modules
print(json.dumps({"cold": cold, "warm": warm, "foreign": foreign_modules()}))
"""


class Run:
    """One bench run: the result line, the budget and its watchdog, the
    child processes to reap and the failures found."""

    def __init__(self, budget_s: float):
        self.t0 = time.time()
        self.deadline = self.t0 + budget_s
        self.result = {
            "metric": "chaincleaner_chr1_wallclock", "value": None,
            "unit": "s_end_to_end(warm median, port on the card, default "
                    "mode; vs C incl. netting)",
            "vs_baseline": None,
            "extra": {"budget_s": budget_s, "host_cores": os.cpu_count(),
                      "sections_done": [], "failures": []}}
        self.live: list = []
        self._emitted = False
        self._lock = threading.Lock()

    @property
    def extra(self) -> dict:
        return self.result["extra"]

    def remaining(self) -> float:
        return self.deadline - time.time()

    def fail(self, msg: str) -> None:
        log(f"FAILURE: {msg}")
        self.extra["failures"].append(msg)

    def emit(self, tag: str) -> bool:
        """Print the line once; False when it was printed already."""
        with self._lock:
            if self._emitted:
                return False
            self._emitted = True
            self.extra["elapsed_s"] = time.time() - self.t0
            self.extra["completed"] = tag
            print(json.dumps(self.result), flush=True)
            return True

    def exit_code(self) -> int:
        return 1 if self.extra["failures"] else 0

    def watchdog(self) -> None:
        while True:
            left = self.deadline - MARGIN_S - time.time()
            if left <= 0:
                break
            time.sleep(min(left, 1.0))
        for p in list(self.live):
            with contextlib.suppress(OSError):
                p.kill()
        if self.emit("watchdog(budget exhausted)"):
            os._exit(self.exit_code())


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def environ(env: dict):
    """Set each name of env for the block (None: unset it), then restore."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spread(times: list[float]) -> dict:
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "runs": times}


def same_files(pairs) -> bool:
    """Whether each (a, b) of pairs holds the same bytes."""
    for a, b in pairs:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "genomealignmenttools_tpu"
                  or m.startswith("genomealignmenttools_tpu."))


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(once, dev) -> dict:
    """One cold run of `once`, then WARM_RUNS warm runs (each ending in a
    device synchronise): seconds, CPU seconds of this process per warm run,
    the phase split (mean over the warm runs) and every kernel's launches
    over all the runs."""
    from .device import LAUNCHES
    from .utils.profiling import phase_acc_start, phase_acc_stop

    def timed():
        t0 = time.monotonic()
        once()
        sync(dev)
        return time.monotonic() - t0

    before = dict(LAUNCHES)
    cold = timed()
    cpu0 = os.times()
    phase_acc_start()
    warm = [timed() for _ in range(WARM_RUNS)]
    phases = phase_acc_stop()
    cpu1 = os.times()
    return {"cold_s": cold, "warm_s": spread(warm),
            "cpu_s_per_warm_run": ((cpu1.user - cpu0.user)
                                   + (cpu1.system - cpu0.system)) / WARM_RUNS,
            "warm_phase_s": {k: v / WARM_RUNS for k, v in phases.items()},
            "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}}


def check_launches(run: Run, dev, section: str, mode: str, launches: dict,
                   must: str | None) -> None:
    """The host-native oracle launches nothing; on the card a mode that
    scores on a kernel must have launched it."""
    if mode in ("hostnative", "host"):
        if any(launches.values()):
            run.fail(f"{section} ({mode}) launched a kernel: {launches}")
    elif dev.type == "cuda" and must is not None and launches[must] == 0:
        run.fail(f"{section} ({mode}) never launched {must}")


# ---------------------------------------------------------------------------
# C reference (live where .ref_build/ holds the binaries)
# ---------------------------------------------------------------------------

def _have_ref() -> bool:
    return (os.path.exists(os.path.join(REF_BIN, "chainCleaner"))
            and os.path.exists(os.path.join(KENT_BIN, "chainSort")))


def _boot_id():
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        return None


def _ref_env() -> dict:
    env = dict(os.environ)
    env["PATH"] = f"{REF_BIN}:{KENT_BIN}:" + env["PATH"]
    return env


def c_timing(run: Run, cache_path: str, run_c, need_s: float) -> tuple:
    """(wall_s, cpu_s, source) of the C tool: cached for the same boot (same
    machine, same page-cache regime; the root bench's rule for the C
    binary), else best of two live runs when the binaries exist, else
    (None, None, None)."""
    cache = None
    with contextlib.suppress(OSError, ValueError):
        with open(cache_path) as f:
            cache = json.load(f)
    if cache and cache.get("boot_id") == _boot_id():
        return cache["c_total_s"], cache.get("c_cpu_s"), "cached(same boot)"
    if not _have_ref() or run.remaining() < need_s:
        return None, None, None
    wall, cpu = run_c()
    if run.remaining() > wall + need_s / 2:
        w2, c2 = run_c()
        if w2 < wall:
            wall, cpu = w2, c2
    with open(cache_path, "w") as f:
        json.dump({"c_total_s": wall, "c_cpu_s": cpu, "boot_id": _boot_id()},
                  f)
    return wall, cpu, "live"


def _children_timed(fn) -> tuple[float, float]:
    """(wall, children's CPU seconds) of fn (the C binaries are this
    process's only children while it runs)."""
    tc0, t0 = os.times(), time.monotonic()
    fn()
    tc1 = os.times()
    return (time.monotonic() - t0,
            (tc1.children_user - tc0.children_user)
            + (tc1.children_system - tc0.children_system))


def c_cleaner(run: Run, m: dict, d: str) -> tuple:
    env = _ref_env()

    def once():
        pre_net = os.path.join(d, "c_pre.net")
        with open(pre_net, "w") as f:
            p1 = subprocess.Popen(
                ["chainNet", "-minScore=0", m["chain"], m["t_sizes"],
                 m["q_sizes"], "stdout", "/dev/null"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
            subprocess.run(["NetFilterNonNested.perl", "/dev/stdin",
                            "-minScore1", "3000"], stdin=p1.stdout, stdout=f,
                           env=env, check=True)
            p1.wait()
        subprocess.run(
            ["chainCleaner", m["chain"], m["t2bit"], m["q2bit"],
             os.path.join(d, "c_out.chain"), os.path.join(d, "c_out.bed"),
             "-net=" + pre_net, "-tSizes=" + m["t_sizes"],
             "-qSizes=" + m["q_sizes"], "-linearGap=loose"],
            env=env, check=True, capture_output=True)

    return c_timing(run, os.path.join(d, "C_TIME.json"),
                    lambda: _children_timed(once), 90)


def c_chainnet(run: Run, m: dict, d: str) -> tuple:
    env = _ref_env()

    def once():
        subprocess.run(
            ["chainNet", "-rescore", "-linearGap=loose",
             "-tNibDir=" + m["t2bit"], "-qNibDir=" + m["q2bit"], m["chain"],
             m["t_sizes"], m["q_sizes"], os.path.join(d, "c_rescore.t.net"),
             os.path.join(d, "c_rescore.q.net")],
            env=env, check=True, capture_output=True)

    return c_timing(run, os.path.join(d, "C_NET_TIME.json"),
                    lambda: _children_timed(once), 45)


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------

def by_mode(run: Run, dev, section: str, once_for, must=MUST_LAUNCH) -> dict:
    """measure() of once_for(mode) in each scoring mode under its
    environment, keyed port_window, port_pair and hostnative: the card modes
    first (the first run of the first mode is the only one that decodes the
    genomes), then the host-native oracle."""
    out = {}
    for mode in ("window", "pair", "hostnative"):
        with environ(MODES[mode]):
            r = measure(once_for(mode), dev)
        check_launches(run, dev, section, mode, r["launches"], must.get(mode))
        log(f"{section} {mode}: warm median {r['warm_s']['median']:.4f} s, "
            f"cold {r['cold_s']:.4f} s, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
        out[mode if mode == "hostnative" else f"port_{mode}"] = r
    return out


def parity(run: Run, section: str, outs: dict, c_outs=None) -> dict:
    """Byte identity of each card mode's output files with the host-native
    run's, and of the host-native run's with C's (c_outs, where C ran
    live); a difference is a failure."""
    same = {f"{mode}_vs_hostnative": same_files(zip(outs[mode],
                                                    outs["hostnative"]))
            for mode in ("window", "pair")}
    if c_outs:
        same["hostnative_vs_C"] = same_files(zip(outs["hostnative"], c_outs))
    for k, ok in same.items():
        if not ok:
            run.fail(f"{section}: outputs differ ({k})")
    return same


def c_or_recorded(c: tuple, base: dict, key: str) -> tuple:
    """C's (wall, cpu, source) as measured, else the recorded wall of
    bench_baseline.json (key), labelled as taken on another machine."""
    if c[0] is None and base.get(key):
        return base[key], None, C_RECORDED.format(base.get("measured"))
    return c


def bench_cleaner(run: Run, dev, m: dict, d: str, base: dict) -> None:
    from .engines.chain_cleaner import clean_chains

    c_wall, c_cpu, c_source = c_or_recorded(c_cleaner(run, m, d), base,
                                            "c_chaincleaner_chr1_s")
    outs = {mode: (os.path.join(d, f"out.{mode}.chain"),
                   os.path.join(d, f"out.{mode}.bed")) for mode in MODES}

    def once_for(mode):
        return lambda: clean_chains(
            m["chain"], m["t2bit"], m["q2bit"], *outs[mode],
            t_sizes=m["t_sizes"], q_sizes=m["q_sizes"], linear_gap="loose",
            device=dev)

    res = by_mode(run, dev, "cleaner", once_for)
    same = parity(run, "cleaner", outs, c_source == "live" and (
        os.path.join(d, "c_out.chain"), os.path.join(d, "c_out.bed")))
    value = res["port_window"]["warm_s"]["median"]
    run.extra["cleaner"] = {
        "c_total_s": c_wall, "c_cpu_s": c_cpu, "c_time_source": c_source,
        **res, "warm_1thread_s": None, "byte_identical": same,
        "outputs": {"chain": outs["window"][0], "bed": outs["window"][1]}}
    run.result["value"] = value
    run.result["vs_baseline"] = c_wall / value if c_wall else None
    our_cpu = res["hostnative"]["cpu_s_per_warm_run"]
    run.extra["normalized"] = {
        "c_wall_s": c_wall, "c_cpu_s": c_cpu,
        "gat_cpu_s_per_warm_run": {
            mode: r["cpu_s_per_warm_run"] for mode, r in res.items()},
        "ratio_wall": run.result["vs_baseline"],
        "ratio_wall_hostnative": (c_wall / res["hostnative"]["warm_s"]
                                  ["median"] if c_wall else None),
        "ratio_cpu_per_core": c_cpu / our_cpu if c_cpu and our_cpu else None,
        "c_band_s": base.get("c_chaincleaner_band_s"),
        "note": "ratio_wall = C wall / the port's warm median on the card "
                "(default mode); ratio_cpu_per_core = C CPU-s / the "
                "host-native run's CPU-s per warm run (live C only); "
                "c_band_s = min/max C wall across machines "
                "(bench_baseline.json)"}


def bench_chainnet(run: Run, dev, m: dict, d: str, base: dict) -> None:
    from .engines.chain_net import chain_net

    c_wall, _, c_source = c_or_recorded(c_chainnet(run, m, d), base,
                                        "c_chainnet_rescore_chr1_s")
    outs = {mode: (os.path.join(d, f"rescore.{mode}.t.net"),
                   os.path.join(d, f"rescore.{mode}.q.net")) for mode in MODES}

    def once_for(mode):
        def once():
            with open(outs[mode][0], "w") as t_out, \
                    open(outs[mode][1], "w") as q_out:
                chain_net(m["chain"], m["t_sizes"], m["q_sizes"], t_out,
                          q_out, rescore=True, t_2bit=m["t2bit"],
                          q_2bit=m["q2bit"], linear_gap="loose", device=dev)
        return once

    res = by_mode(run, dev, "chainnet_rescore", once_for)
    same = parity(run, "chainnet_rescore", outs, c_source == "live" and (
        os.path.join(d, "c_rescore.t.net"),
        os.path.join(d, "c_rescore.q.net")))
    run.extra["chainnet_rescore"] = {
        "c_total_s": c_wall, "c_time_source": c_source, **res,
        "byte_identical": same,
        "outputs": {"t_net": outs["window"][0], "q_net": outs["window"][1]}}


def bench_scorechain(run: Run, dev, meta: dict, d: str, base: dict) -> None:
    from .engines.score_chain import score_chain_file

    outs = {mode: (os.path.join(d, f"scored.{mode}.chain"),) for mode in MODES}

    def once_for(mode):
        return lambda: score_chain_file(meta["chain"], meta["t2bit"],
                                        meta["q2bit"], outs[mode][0],
                                        linear_gap="loose", device=dev)

    res = by_mode(run, dev, "scorechain", once_for,
                  must={"window": "rescore_chunks"})
    ali_mb = meta["aligned_bases"] / 1e6
    for r in res.values():
        r["cold_mb_s"] = ali_mb / r["cold_s"]
        r["warm_mb_s"] = ali_mb / r["warm_s"]["median"]
    c_wall = base.get("c_scorechain_wall_s")
    run.extra["scorechain"] = {
        "ali_mb": ali_mb, **res,
        "scorechain_warm_vs_c": (
            c_wall / res["port_window"]["warm_s"]["median"] if c_wall
            else None),
        "c_source": (C_RECORDED.format(base.get("measured")) if c_wall
                     else None),
        "byte_identical": parity(run, "scorechain", outs),
        "outputs": {"chain": outs["window"][0]}}


def link_figures(dev) -> dict | None:
    """A null launch's round trip (enqueue, run, synchronise) and pinned
    host-to-device GB/s, on the card; None elsewhere."""
    import torch
    if dev.type != "cuda":
        return None
    x = torch.zeros(8, device=dev)
    x.add_(1)
    torch.cuda.synchronize(dev)
    n = 200
    t0 = time.monotonic()
    for _ in range(n):
        x.add_(1)
        torch.cuda.synchronize(dev)
    rtt_ms = (time.monotonic() - t0) / n * 1e3
    a = torch.zeros(64 * 1024 * 1024, dtype=torch.uint8).pin_memory()
    best = float("inf")
    for _ in range(5):
        t0 = time.monotonic()
        a.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)
        best = min(best, time.monotonic() - t0)
    return {"null_launch_rtt_ms": rtt_ms, "h2d_pinned_gbs": a.numel() / best
            / 1e9, "h2d_bytes": a.numel()}


def bench_resident(run: Run, dev, meta: dict) -> None:
    import numpy as np

    from .device import LAUNCHES
    from .device.genome import open_genome
    from .formats.chain import read_chains
    from .formats.gapcalc import gap_calc_from_file
    from .formats.scorematrix import score_scheme_default
    from .ops.pair_rescore import TorchPairChainScorer
    from .ops.rescore import TorchChainScorer

    scheme, gap_calc = score_scheme_default(), gap_calc_from_file("loose")
    t_gen, q_gen = open_genome(meta["t2bit"]), open_genome(meta["q2bit"])
    chains = read_chains(meta["chain"])
    ali_mb = meta["aligned_bases"] / 1e6

    host = TorchChainScorer(scheme, gap_calc, t_gen, q_gen, mode="hostnative")

    def host_once():
        t0 = time.monotonic()
        out = host.score_chains(chains)
        return time.monotonic() - t0, out

    host_cold, want = host_once()
    host_warm = [host_once()[0] for _ in range(WARM_RUNS)]

    with environ({"GAT_PAIR_TILES": None}):
        scorer = TorchChainScorer(scheme, gap_calc, t_gen, q_gen, device=dev,
                                  mode="pair")
        pcs = TorchPairChainScorer(scorer._dev, gap_calc)
        jobs, order = scorer._grouped(chains)
        nblocks = [chains[i].n_blocks for i in order]
        before = dict(LAUNCHES)
        t0 = time.monotonic()
        hbm = pcs.resident_hbm_bytes(jobs, nblocks)   # packs, uploads, meta
        sync(dev)
        setup_s = time.monotonic() - t0

        def chained(n):
            t0 = time.monotonic()
            out = pcs.score_chained(jobs, nblocks, n)   # ends in a fetch
            return time.monotonic() - t0, out

        first_s, out0 = chained(1)
        singles, longs = [], []
        for _ in range(WARM_RUNS):
            dt, out = chained(1)
            singles.append(dt)
            if not np.array_equal(out, out0):
                run.fail("resident: a single pass changed the scores")
            dt, out = chained(CHAINED_PASSES)
            longs.append(dt)
            if not np.array_equal(out, out0):
                run.fail("resident: chained passes changed the scores")
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    got = [(int(g), int(loc)) for g, loc in out0.tolist()]
    same = got == [(int(want[i][0]), int(want[i][1])) for i in order]
    if not same:
        run.fail("resident: (global, local) differ from the host-native "
                 "scores")
    check_launches(run, dev, "resident", "pair", launches, "pair_combine")
    t1 = statistics.median(singles)
    sustained = [(tn - t1) / (CHAINED_PASSES - 1) for tn in longs]
    per_pass = statistics.median(sustained)
    run.extra["resident"] = {
        "n_chains": len(chains), "ali_mb": ali_mb,
        "setup_s": setup_s, "first_pass_s": first_s,
        "single_pass_s": spread(singles),
        "chained_41_s": spread(longs),
        "sustained_pass_s": spread(sustained),
        "resident_hbm_bytes": hbm,
        "sustained_gbs": hbm / per_pass / 1e9 if per_pass > 0 else None,
        "sustained_mb_aligned_s": ali_mb / per_pass if per_pass > 0 else None,
        "pct_of_h100_hbm_3_35_tbs": (100 * hbm / per_pass / HBM_BYTES_PER_S
                                     if dev.type == "cuda" and per_pass > 0
                                     else None),
        "launches": launches, "matches_hostnative": same,
        "link": link_figures(dev),
        "hostnative": {"cold_s": host_cold, "warm_s": spread(host_warm),
                       "mb_aligned_s": ali_mb / statistics.median(host_warm)}}
    log(f"resident: sustained {per_pass * 1e3:.4f} ms a pass, single "
        f"{t1 * 1e3:.3f} ms, {hbm} bytes a pass")


def bench_repeatfiller(run: Run, dev, m: dict, n_gaps: int) -> None:
    from .device import LAUNCHES
    from .device.genome import open_genome
    from .engines.repeat_filler import _run_gap_jobs, harvest_gap_jobs
    from .formats.gapcalc import gap_calc_from_file
    from .formats.scorematrix import score_scheme_default
    from .ops.seed_extend import GapAligner

    with open(m["chain"]) as f:
        lines = [ln + "\n" for ln in f.read().split("\n")]
    jobs = harvest_gap_jobs(lines, 0, 0, 0, 10, 10, 100000, 100000)[:n_gaps]
    scheme = score_scheme_default()
    gc = gap_calc_from_file("loose")
    tg, qg = open_genome(m["t2bit"]), open_genome(m["q2bit"])

    def aligner():
        return GapAligner(scheme.lut, seed_len=6, hsp_threshold=1500,
                          gapped_threshold=2000, gap_open=scheme.gap_open,
                          gap_extend=scheme.gap_extend,
                          char_matrix=scheme.char_matrix(), device=dev)

    def fill(al, some):
        h, filled = hashlib.md5(), 0
        for _job, minis in _run_gap_jobs(some, tg, qg, al, scheme, gc):
            if minis:
                filled += 1
                h.update(minis[0].to_text().encode())
        return h.hexdigest(), filled

    def timed(al, some):
        before = dict(LAUNCHES)
        t0 = time.monotonic()
        checksum, filled = fill(al, some)
        sync(dev)
        return (time.monotonic() - t0, checksum, filled,
                {k: LAUNCHES[k] - before[k] for k in LAUNCHES})

    gap_mb = sum(j.t_gap_end - j.t_block_end for j in jobs) / 1e6
    res = {"n_gaps": len(jobs), "gap_mb": gap_mb}
    for mode, env in (("host", {"GAT_BAND": "host"}),
                      ("device", {"GAT_BAND": None})):
        with environ(env):
            al = aligner()
            warmup_s, *_ = timed(al, jobs[:8])   # the card's first launch
            secs, checksum, filled, launches = timed(al, jobs)
        check_launches(run, dev, "repeatfiller", mode, launches,
                       "band_ext" if mode == "device" else None)
        res[mode] = {"s": secs, "gaps_per_s": len(jobs) / secs,
                     "mb_gap_per_s": gap_mb / secs, "warmup_8_gaps_s":
                     warmup_s, "filled": filled, "checksum": checksum,
                     "launches": launches}
        log(f"repeatfiller {mode}: {secs:.3f} s, {filled} filled")
    res["device_matches_host"] = (res["device"]["checksum"]
                                  == res["host"]["checksum"])
    if not res["device_matches_host"]:
        run.fail("repeatfiller: the card's checksum differs from the host "
                 "band batch's")
    run.extra["repeatfiller"] = res


def bench_single_thread(run: Run, m: dict, d: str) -> None:
    """The host-native chainCleaner at GAT_THREADS=1 in a subprocess of the
    port: the native library caches the thread count in a static, so an
    in-process change would stay multithreaded."""
    chain, bed = os.path.join(d, "out.1thread.chain"), \
        os.path.join(d, "out.1thread.bed")
    env = dict(os.environ, GAT_RESCORE="hostnative", GAT_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    p = subprocess.Popen(
        [sys.executable, "-c", _SINGLE_THREAD,
         json.dumps([m, chain, bed, WARM_RUNS])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    run.live.append(p)
    try:
        out, err = p.communicate(timeout=max(run.remaining() - MARGIN_S, 1))
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        log("cleaner_1thread: out of budget")
        return
    finally:
        run.live.remove(p)
    if p.returncode != 0:
        run.fail(f"cleaner_1thread: exit {p.returncode}: {err[-2000:]}")
        return
    r = json.loads(out.strip().splitlines()[-1])
    if r["foreign"]:
        run.fail(f"cleaner_1thread loaded {r['foreign']}")
    hn = (os.path.join(d, "out.hostnative.chain"),
          os.path.join(d, "out.hostnative.bed"))
    same = same_files(zip((chain, bed), hn))
    if not same:
        run.fail("cleaner_1thread: outputs differ from the multithreaded "
                 "host-native run")
    run.extra["cleaner"]["warm_1thread_s"] = spread(r["warm"])
    run.extra["cleaner"]["cold_1thread_s"] = r["cold"]
    run.extra["cleaner"]["byte_identical"]["1thread_vs_hostnative"] = same


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------

def device_info(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {"type": "cpu", "note": "plain PyTorch versions of the "
                "kernels; every time is a CPU time"}
    smi = None
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "nvidia_smi_name_power_limit": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m genomealignmenttools_tpu_torch.bench",
        description="The port's bench; prints one JSON line, last.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu (for the tests)")
    ap.add_argument("--cleaner-scenarios", type=int, default=2000)
    ap.add_argument("--cleaner-bulk", type=int, default=30000)
    ap.add_argument("--chr1-size", type=int, default=256_000_000)
    ap.add_argument("--chr1-chains", type=int, default=384)
    ap.add_argument("--rf-gaps", type=int, default=600,
                    help="gap jobs timed (the root bench's n_time)")
    return ap.parse_args(argv)


def sections(run: Run, args, dev, work_dir: str):
    """(name, callable) in the root bench's order; each callable builds its
    workload (cached) and fills its part of the result."""
    from .utils.bench_workload import (build_cleaner_workload,
                                       build_repeatfiller_workload,
                                       build_workload)
    base = {}
    with contextlib.suppress(OSError, ValueError):
        with open(BASELINE_PATH) as f:
            base = json.load(f)
    cl_dir = os.path.join(work_dir, f"cleaner_{args.cleaner_scenarios}_"
                                    f"{args.cleaner_bulk}")
    chr1_dir = os.path.join(work_dir, f"chr1_{args.chr1_size}_"
                                      f"{args.chr1_chains}")
    rf_dir = os.path.join(work_dir, f"repeatfiller_{RF_WORKLOAD_GAPS}")
    w = {}

    def timed_build(key, fn, *a, **kw):
        t0 = time.monotonic()
        w[key] = fn(*a, **kw)
        run.extra["setup"][f"workload_{key}_s"] = time.monotonic() - t0

    return [
        ("workload_cleaner", lambda: timed_build(
            "cleaner", build_cleaner_workload, cl_dir,
            n_scenarios=args.cleaner_scenarios, n_bulk=args.cleaner_bulk)),
        ("cleaner", lambda: bench_cleaner(run, dev, w["cleaner"], cl_dir,
                                          base)),
        ("chainnet_rescore", lambda: bench_chainnet(run, dev, w["cleaner"],
                                                    cl_dir, base)),
        ("workload_chr1", lambda: timed_build(
            "chr1", build_workload, chr1_dir, t_size=args.chr1_size,
            n_chains=args.chr1_chains)),
        ("scorechain", lambda: bench_scorechain(run, dev, w["chr1"],
                                                chr1_dir, base)),
        ("resident", lambda: bench_resident(run, dev, w["chr1"])),
        ("workload_repeatfiller", lambda: timed_build(
            "repeatfiller", build_repeatfiller_workload, rf_dir,
            n_gaps=RF_WORKLOAD_GAPS)),
        ("repeatfiller", lambda: bench_repeatfiller(
            run, dev, w["repeatfiller"], args.rf_gaps)),
        ("cleaner_1thread", lambda: bench_single_thread(run, w["cleaner"],
                                                        cl_dir)),
    ]


def main(argv=None) -> int:
    args = parse_args(argv)
    run = Run(float(os.environ.get("GAT_BENCH_BUDGET_S", "390")))
    threading.Thread(target=run.watchdog, daemon=True).start()
    work_dir = os.environ.get("GAT_BENCH_DIR") or os.path.join(
        tempfile.gettempdir(), "gat_bench_torch")
    os.makedirs(work_dir, exist_ok=True)
    run.extra["sizes"] = {
        "cleaner_n_scenarios": args.cleaner_scenarios,
        "cleaner_n_bulk": args.cleaner_bulk,
        "chr1_t_size": args.chr1_size, "chr1_n_chains": args.chr1_chains,
        "repeatfiller_n_gaps": args.rf_gaps,
        "repeatfiller_workload_gaps": RF_WORKLOAD_GAPS}
    run.extra["setup"] = {}

    from .device import resolve_device
    from .native import get_lib
    from .utils.verbose import set_verbosity
    set_verbosity(0)
    try:
        dev = resolve_device(args.device)   # raises where CUDA is absent
    except (RuntimeError, ValueError) as e:
        run.fail(f"device: {e}")
        run.emit("no device")
        return run.exit_code()
    run.extra["device"] = device_info(dev)
    t0 = time.monotonic()
    get_lib()
    if dev.type == "cuda":
        from ._build import load_library
        load_library()
    run.extra["setup"]["libraries_s"] = time.monotonic() - t0

    for name, fn in sections(run, args, dev, work_dir):
        try:
            fn()
        except Exception as e:   # a section's failure must not hide the rest
            import traceback
            traceback.print_exc()
            run.fail(f"{name} raised {type(e).__name__}: {e}")
            if name.startswith("workload_"):
                break   # the sections after it need the workload
            continue
        run.extra["sections_done"].append(name)
        log(f"{name} done at {time.time() - run.t0:.1f} s")

    foreign = foreign_modules()
    if foreign:
        run.fail(f"jax or the JAX package was loaded: {foreign}")
    run.emit("all")
    return run.exit_code()


if __name__ == "__main__":
    sys.exit(main())
