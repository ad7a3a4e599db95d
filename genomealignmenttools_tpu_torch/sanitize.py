"""Sanitizer runs of the port: its four CUDA kernels under four checking
tools on a card, and its native host library under ThreadSanitizer.  The
port's counterpart of tools/tsan_check.sh.

    python -m genomealignmenttools_tpu_torch.sanitize cuda
        [--checker compute-sanitizer|builtin] [--tools memcheck,racecheck,...]
        [--timeout SECONDS] [--device cuda:N] [--out DIR] [--large]
    python -m genomealignmenttools_tpu_torch.sanitize tsan [--timeout SECONDS]

Run from a checkout: the kernel cases come from tests/rescore_cases.py,
tests/combine_cases.py and tests/band_cases.py, the fixtures and goldens
from tests/.

cuda (needs a CUDA card).  One child process a tool (memcheck, racecheck,
synccheck, initcheck), all started together, each with
PYTORCH_NO_CUDA_MEMORY_CACHING=1 so that every tensor is an allocation of
its own size.  Each child loads a copy of the kernels built with -lineinfo
(_build.py: build/lineinfo/, or build/checked/ for the builtin checker) and
launches every entry point of K1, K2, K3 and K4 on the edge cases of the GPU
tests' tables (kernel_cases below), and writes a digest of each launch's
outputs; the parent holds every digest to that of the plain PyTorch version
on the same inputs, which it computes meanwhile with two helper processes
(`plain`, PLAIN_SHARDS), each taking a third of the cases by cost and
making a third of K2's host tile rows, which every process of the run then
reads from files (write_inputs); a caller that has the plain digests of
some cases already (chip_smoke.py's [kernel K3] phase, K3's) passes them
in, and those are not run again.  The memcheck child
then runs the port's CLI on the fixtures: scoreChain, chainNet -rescore and
chainCleaner in window mode and in each pair tile format, byte-compared with
tests/golden; RepeatFiller --refQuirks against its golden; RepeatFiller,
patchChain and patchChain -unmask against the port's host band batch
(GAT_BAND=host) in the same process, as chip_smoke.py's [gap fixtures]
does, there being no golden for them.

  --checker compute-sanitizer (the default): each child runs under
      compute-sanitizer --tool T --error-exitcode 9 --kernel-name kns=K ...
  for the port's four __global__ functions K (KERNELS), so that torch's
  own kernels are out of scope; its ERROR SUMMARY (RACECHECK SUMMARY for
  racecheck) gives the errors.
  --checker builtin: each child loads build/checked/ (-DGAT_CHECKED) and
  arms the tool inside the kernels (csrc/check.cuh), for machines where
  compute-sanitizer cannot attach to the card (through gVisor it
  answers "Device not supported"); it prints its reports and an ERROR
  SUMMARY line of the same form.

--large: instead of those cases, K1 at chr1's shape and K2's four entries
on 200,000 chains (_large_cases), too large for chip_smoke.py's phase.

The parent prints one line a tool (launches per kernel, errors, seconds) and
exits 1 if a tool reports an error or prints no summary, a child fails or
outlives --timeout, a launch differs from its plain version, a kernel is
never launched, a CLI output differs, or compute-sanitizer is not found.

tsan (on the CPU).  Builds the port's native/*.cpp with g++ -O1 -g -fPIC
-shared -std=c++17 -pthread -fsanitize=thread into a scratch directory
($TMPDIR/gat_tsan_torch) and runs a child under LD_PRELOAD=<g++'s
libtsan.so> with GAT_NATIVE_SO naming the build, GAT_THREADS=8 and
CUDA_VISIBLE_DEVICES= (CUDA does not run under TSAN's shadow mappings): the
port's chainCleaner, chainNet -rescore and scoreChain on
build_cleaner_workload(200 scenarios, 3,000 bulk chains) with
GAT_RESCORE=hostnative, then RepeatFiller on 120 gaps with GAT_BAND=host
(the threaded HSP scan, the host band batch and the chaining of every gap
in one native call, which the child checks ran).  A race report (a
"WARNING: ThreadSanitizer" line, or TSAN's exit code 66) fails the run.

Imports nothing of jax and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(_PKG)
TESTS = os.path.join(REPO, "tests")
FIX = os.path.join(TESTS, "fixtures")
GOLD = os.path.join(TESTS, "golden")

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
TOOL_BITS = {"memcheck": 1, "racecheck": 2, "synccheck": 4, "initcheck": 8}
CHECKERS = ("compute-sanitizer", "builtin")
VARIANT = {"compute-sanitizer": "lineinfo", "builtin": "checked"}
# the port's __global__ functions (csrc/*.cu), every instantiation
KERNELS = ("rescore_chunks_kernel", "combine_kernel", "band_ext_kernel",
           "hsp_best_kernel")
# the LAUNCHES key of every entry point of the four kernels
LAUNCH_KEYS = ("rescore_chunks", "pair_combine", "pair_combine_code",
               "pair_combine_score4", "band_ext", "hsp_best")
# the keys that --large does not launch
NOT_LARGE = ("band_ext", "hsp_best")
ERROR_EXIT = 9
TIMEOUT_S = 600
PLAIN_SHARDS = 3      # the parent and two helpers share the plain run
CHILD_ENV = {"PYTORCH_NO_CUDA_MEMORY_CACHING": "1"}
SUMMARY = re.compile(r"^=+ ERROR SUMMARY: (\d+) errors?\s*$", re.M)
RACE_SUMMARY = re.compile(
    r"^=+ RACECHECK SUMMARY: \d+ hazards? displayed \((\d+) errors?, "
    r"(\d+) warnings?\)\s*$", re.M)
REFUSED = "Device not supported"
CUDA_HOMES = ("/usr/local/cuda",)   # searched after $CUDA_HOME, before PATH

# ---------------------------------------------------------------- commands


def find_compute_sanitizer() -> str:
    """compute-sanitizer's path: CUDA_HOME's, /usr/local/cuda's or PATH's;
    raises FileNotFoundError where there is none."""
    for home in (os.environ.get("CUDA_HOME"), *CUDA_HOMES):
        if home:
            exe = os.path.join(home, "bin", "compute-sanitizer")
            if os.path.exists(exe):
                return exe
    found = shutil.which("compute-sanitizer")
    if found is None:
        raise FileNotFoundError(
            "compute-sanitizer not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def kernel_filter() -> list[str]:
    """compute-sanitizer's options that check the port's kernels and no
    other: a substring of each mangled name."""
    return [a for k in KERNELS for a in ("--kernel-name", f"kns={k}")]


def sanitizer_command(exe: str, tool: str, argv: list[str]) -> list[str]:
    if tool not in TOOLS:
        raise ValueError(f"unknown tool {tool!r}; one of {TOOLS}")
    return [exe, "--tool", tool, "--error-exitcode", str(ERROR_EXIT),
            "--print-limit", "100", *kernel_filter(), *argv]


def _module_argv(*args: str) -> list[str]:
    return [sys.executable, "-m", "genomealignmenttools_tpu_torch.sanitize",
            *args]


def child_command(tool: str, checker: str, device: str, out: str,
                  exe: str | None = None, large: bool = False,
                  inputs: str | None = None) -> list[str]:
    """The child of one tool; under compute-sanitizer where that checker is
    chosen (exe: its path)."""
    argv = _module_argv("child", "--tool", tool, "--checker", checker,
                        "--device", device, "--out", out, "--wait-build",
                        *(["--large"] if large else []),
                        *(["--inputs", inputs] if inputs else []))
    if checker == "compute-sanitizer":
        return sanitizer_command(exe or find_compute_sanitizer(), tool, argv)
    if checker != "builtin":
        raise ValueError(f"unknown checker {checker!r}; one of {CHECKERS}")
    return argv


def child_env(base: dict | None = None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(CHILD_ENV)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def parse_summary(text: str) -> int:
    """The errors of a tool's last summary line (errors and warnings of
    racecheck's); raises ValueError where there is none."""
    found = [(m.start(), int(m.group(1))) for m in SUMMARY.finditer(text)]
    found += [(m.start(), int(m.group(1)) + int(m.group(2)))
              for m in RACE_SUMMARY.finditer(text)]
    if not found:
        raise ValueError("no ERROR SUMMARY line in the tool's output")
    return max(found)[1]


def summary_line(errors: int) -> str:
    return f"========= ERROR SUMMARY: {errors} error{'' if errors == 1 else 's'}"

# ---------------------------------------------------------------- the cases


def _tests_module(name: str):
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    return __import__(name)


class Case:
    """One launch of a kernel entry: `build()` makes its device tensors,
    `run(kernel, tensors)` the kernel's wrapper (kernel=True) or the plain
    version (False) on them; `key` is the LAUNCHES key; `twice` runs the
    wrapper twice for the same bits; `cost` weighs the plain run (about
    2.5 ms of one CPU core a unit) for sharing it out."""

    def __init__(self, label, key, build, run, twice=False, cost=1.0):
        self.label, self.key, self.build, self.run = label, key, build, run
        self.twice, self.cost = twice, cost


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        a = t.detach().cpu().contiguous()
        h.update(f"{a.dtype}{tuple(a.shape)}".encode())
        h.update(a.numpy().tobytes())
    return h.hexdigest()


def _k1_cases(dev):
    import numpy as np
    import torch

    from .formats.scorematrix import score_scheme_default
    from .ops import window_rescore as wr
    rc = _tests_module("rescore_cases")
    lut = wr.checked_lut(score_scheme_default().lut)

    def run(kernel, args):
        fn = wr.chunk_sums if kernel else wr.chunk_sums_plain
        return [fn(args[0], args[1], lut, *args[2:])]

    def whole(case):
        return lambda: [torch.from_numpy(a).to(dev) for a in case]

    def views(case):
        # the code tensors start 3 and 9 bytes into their storage
        def build():
            t, q, t_off, q_off, length = case
            keep = (t_off >= 3) & (q_off >= 9)
            pad = [np.full(k, 9, np.uint8) for k in (3, 9)]
            return [torch.from_numpy(np.concatenate([pad[0], t])).to(dev)[3:],
                    torch.from_numpy(np.concatenate([pad[1], q])).to(dev)[9:],
                    *[torch.from_numpy(a[keep]).to(dev)
                      for a in (t_off - 3, q_off - 9, length)]]
        return build

    case = rc.alignment_case()
    yield Case("K1 every alignment mod 16, whole tensors", "rescore_chunks",
               whole(case), run, cost=20)
    yield Case("K1 every alignment mod 16, offset views", "rescore_chunks",
               views(case), run, cost=20)
    for n in rc.TAIL_LENGTHS:
        yield Case(f"K1 chunks ending at the last byte of {n}-base genomes",
                   "rescore_chunks", whole(rc.tail_case(n)), run)


@functools.lru_cache(maxsize=1)
def _combine_inputs(name: str):
    import numpy as np
    cc = _tests_module("combine_cases")
    from .ops import pair_combine as pc
    rng = np.random.default_rng(20261021)
    if name == "edge":
        return cc.combine_case(rng, *cc.edge_chains(pc.TILE), pad_to=pc.TILE)
    if name == "unpadded":
        return cc.combine_case(rng, *cc.random_chains(rng, 300))
    n = int(name.split()[0])
    return cc.combine_case(rng, *cc.random_chains(rng, n), pad_to=pc.TILE)


K2_INPUTS = ("edge", "unpadded", "7 chains", "800 chains")
K2_CHUNKS = (128, 130, 2, 6, 258)     # 4-bit rows: 64, 65, 1, 3, 129 bytes
K2_KINDS = ("score8", "code", "score4")


def _make_rows(name: str, chunk: int, kind: str):
    """Host tile rows of one input, width and format (both tweaks take
    them): the GPU tests' generators."""
    import numpy as np

    from .ops.pair_rescore import pack_vals16
    cc = _tests_module("combine_cases")
    s, bias, _, _, _, m = _combine_inputs(name)
    rng = np.random.default_rng(chunk)
    if kind == "score8":
        return cc.score_tiles(rng, np.clip(s, -128 * chunk, 127 * chunk),
                              chunk)
    rows = cc.code_tiles(rng, bias.shape[0], chunk)
    rows[m:] = 24
    if kind == "code":
        return rows
    return np.ascontiguousarray(cc.nibble_tiles(
        rows, pack_vals16(cc.WIDE_LUT)[0]))


def _rows_file(name: str, chunk: int, kind: str) -> str:
    return f"k2-{name.replace(' ', '-')}-{chunk}-{kind}.npy"


def _wait_for(path: str, timeout: float = TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError(f"{path} did not appear")
        time.sleep(0.1)


@functools.lru_cache(maxsize=1)
def k2_rows(name: str, chunk: int, kind: str, inputs: str | None = None):
    """K2's host rows of one job: read from the run's directory `inputs`
    (write_inputs; waiting for the file), or made here where it is None."""
    if inputs is None:
        return _make_rows(name, chunk, kind)
    import numpy as np
    path = os.path.join(inputs, _rows_file(name, chunk, kind))
    _wait_for(path)
    return np.load(path)


def _row_jobs(shard: int = 0, shards: int = 1) -> list[tuple]:
    """The (input, width, format) jobs of K2's rows that fall to `shard`:
    dealt largest first, back and forth, so each share costs about the
    same (the 4-bit rows are the code rows plus a pass)."""
    rows = {name: _combine_inputs(name)[0].shape[0] for name in K2_INPUTS}
    weight = {"score8": 2, "code": 2, "score4": 3}
    jobs = sorted(((n, c, k) for n in K2_INPUTS for c in K2_CHUNKS
                   for k in K2_KINDS),
                  key=lambda j: -rows[j[0]] * j[1] * weight[j[2]])
    turn = [i % shards if (i // shards) % 2 == 0 else shards - 1 - i % shards
            for i in range(len(jobs))]
    return [j for j, t in zip(jobs, turn) if t == shard]


def write_inputs(path: str, shard: int = 0, shards: int = 1) -> None:
    """K2's host rows of this shard's jobs into `path`, each file moved into
    place whole: each process of a run makes a share, every process reads
    them all."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    for job in _row_jobs(shard, shards):
        final = os.path.join(path, _rows_file(*job))
        with open(f"{final}.{os.getpid()}.tmp", "wb") as f:
            np.save(f, _make_rows(*job))
        os.replace(f.name, final)


def _k2_cases(dev, inputs=None):
    import numpy as np
    import torch

    from .ops import pair_combine as pc
    from .ops.pair_rescore import pack_vals16, vals16_of
    cc = _tests_module("combine_cases")
    tables = {"score8": None,
              "code": torch.from_numpy(cc.WIDE_LUT.reshape(25).astype(np.int8)),
              "score4": torch.from_numpy(vals16_of(pack_vals16(
                  cc.WIDE_LUT)[1]))}

    def on_dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def run_sums(kernel, args):
        fn = pc.pair_combine_scan if kernel else pc.pair_combine_scan_plain
        return list(fn(*args))

    def run_tiles(kind):
        def run(kernel, args):
            tiles, bias, flags, tweak = args
            fn = (pc.pair_combine_scan_tiles if kernel
                  else pc.pair_combine_scan_tiles_plain)
            return list(fn(tiles, bias, flags, tweak, kind, tables[kind]))
        return run

    for name in K2_INPUTS:
        rows = _combine_inputs(name)[0].shape[0]

        def sums(name=name):
            s, bias, flags, _, _, _ = _combine_inputs(name)
            return on_dev(s, bias, flags)
        yield Case(f"K2 int32 sums, {name}", "pair_combine", sums, run_sums,
                   twice=True, cost=1 + rows / 2000)
        for chunk in K2_CHUNKS:
            for kind in K2_KINDS:
                for tweak in (None, 7):
                    def tiles(name=name, chunk=chunk, kind=kind, tweak=tweak):
                        _, bias, flags, _, _, _ = _combine_inputs(name)
                        tw = (None if tweak is None else torch.tensor(
                            tweak, dtype=torch.int32, device=dev))
                        return [*on_dev(k2_rows(name, chunk, kind, inputs),
                                        bias, flags), tw]
                    width = chunk if kind != "score4" else -(-chunk // 2)
                    yield Case(f"K2 {kind} rows of {width} bytes, tweak "
                               f"{tweak}, {name}", pc.LAUNCH_KEY[kind], tiles,
                               run_tiles(kind), twice=True,
                               cost=1 + rows * (chunk + 8) / 250_000)


def _k3_cases(dev):
    from .formats.scorematrix import score_scheme_default
    from .ops import band_batch as bb
    bc = _tests_module("band_cases")
    cm = score_scheme_default().char_matrix()
    for label, g, gap_open, gap_extend, mi, probs in (
            bc.kernel_cases() + bc.instantiation_cases()):
        mat = bb.BandExtBatch(g, cm, gap_open, gap_extend, mi,
                              device=dev).mat

        def run(kernel, args, g=g, go=gap_open, ge=gap_extend, mi=mi,
                mat=mat):
            fn = bb.band_ext_batch if kernel else bb.band_ext_plain
            return list(fn(*args, mat, g, go, ge, mi))
        # a column loop over every problem's band at once
        columns = max(len(a) for a, _, _ in probs)
        yield Case(f"K3 {label}", "band_ext",
                   lambda probs=probs: bc.raw_inputs(probs, dev), run,
                   cost=columns * (1 + len(probs) * (2 * mi + 1) / 20_000))


def _k4_cases(dev):
    import numpy as np
    import torch

    from .ops import hsp_scan as hs
    hc = _tests_module("hsp_cases")
    lut = torch.from_numpy(hc.hsp_lut().astype(np.int32))

    def run(kernel, args):
        fn = hs.hsp_best if kernel else hs.hsp_best_plain
        return [fn(args[0], args[1], lut, *args[2:])]

    def build():
        return [torch.from_numpy(a).to(dev) for a in hc.edge_case()]
    yield Case("K4 edge windows (1 to 5,000 cells, N, below 0, at K)",
               "hsp_best", build, run, twice=True, cost=4)


# chr1 (hg38) and the chunks of the chr1 bench workload's 384 chains
CHR1_BASES, CHR1_CHUNKS = 248_956_422, 3_068_461


def _large_cases(dev):
    """The cases too large for chip_smoke.py's phase (--large): K1 at chr1's
    shape (random codes with N, chunks of 1..256 bases, the last ending at
    each genome's last byte, the genomes in exact-size allocations) and
    K2's four entries on 200,000 random chains (about 26 million chunks in
    some 13,000 tiles), rows built on the card as the GPU tests build them."""
    import torch

    from .formats.scorematrix import score_scheme_default
    from .ops import pair_combine as pc
    from .ops import window_rescore as wr
    from .ops.pair_rescore import pack_vals16, vals16_of
    cc = _tests_module("combine_cases")
    lut = wr.checked_lut(score_scheme_default().lut)

    def k1():
        g = torch.Generator(device=dev).manual_seed(1)
        t, q = (torch.randint(0, 5, (n,), generator=g, device=dev,
                              dtype=torch.uint8)
                for n in (CHR1_BASES, CHR1_BASES - 7))
        length = torch.randint(1, wr.CHUNK + 1, (CHR1_CHUNKS,), generator=g,
                               device=dev, dtype=torch.int32)
        offs = [torch.randint(0, x.numel() - wr.CHUNK, (CHR1_CHUNKS,),
                              generator=g, device=dev) for x in (t, q)]
        for o, x in zip(offs, (t, q)):
            o[-1] = x.numel() - length[-1]
        return [t, q, *offs, length]

    def run_k1(kernel, args):
        fn = wr.chunk_sums if kernel else wr.chunk_sums_plain
        return [fn(args[0], args[1], lut, *args[2:])]

    yield Case("K1 chr1 shape", "rescore_chunks", k1, run_k1)
    idx_lut25, vals_packed = pack_vals16(cc.WIDE_LUT)
    tables = {"score8": None,
              "code": torch.from_numpy(cc.WIDE_LUT.reshape(25).astype(
                  __import__("numpy").int8)),
              "score4": torch.from_numpy(vals16_of(vals_packed))}

    @functools.lru_cache(maxsize=1)
    def chains():
        import numpy as np
        rng = np.random.default_rng(31)
        s, bias, flags, _, _, m = cc.combine_case(
            rng, *cc.random_chains(rng, 200_000))
        return [torch.from_numpy(a).to(dev) for a in (s, bias, flags)], m

    def sums():
        return chains()[0]

    def rows(kind):
        def build():
            (s, bias, flags), m = chains()
            if kind == "score8":
                tiles = cc.even_tiles_torch(s, 128)
            else:
                tiles = cc.code_tiles_torch(m, 128, dev, seed=5)
                if kind == "score4":
                    tiles = cc.nibble_tiles(tiles, idx_lut25)
            return [tiles, bias, flags,
                    torch.tensor(1, dtype=torch.int32, device=dev)]
        return build

    def run_sums(kernel, args):
        fn = pc.pair_combine_scan if kernel else pc.pair_combine_scan_plain
        return list(fn(*args))

    def run_rows(kind):
        def run(kernel, args):
            fn = (pc.pair_combine_scan_tiles if kernel
                  else pc.pair_combine_scan_tiles_plain)
            return list(fn(*args, kind, tables[kind]))
        return run

    yield Case("K2 int32 sums, 200000 chains", "pair_combine", sums,
               run_sums, twice=True)
    for kind in ("score8", "code", "score4"):
        yield Case(f"K2 {kind} rows of {64 if kind == 'score4' else 128} "
                   f"bytes, tweak 1, 200000 chains", pc.LAUNCH_KEY[kind],
                   rows(kind), run_rows(kind), twice=True)


def kernel_cases(dev, large: bool = False, inputs: str | None = None):
    """Every case of the four kernels: K1, K3 in both modes at every
    instantiation, K4, then K2's four entries (whose rows come from the run's
    directory `inputs` where given, see k2_rows); with `large`, only the
    cases of _large_cases."""
    if large:
        yield from _large_cases(dev)
        return
    yield from _k1_cases(dev)
    yield from _k3_cases(dev)
    yield from _k4_cases(dev)
    yield from _k2_cases(dev, inputs)


def run_cases(dev, kernel: bool, cases=None, seconds=None,
              large: bool = False, unstable: list | None = None,
              inputs: str | None = None) -> dict:
    """{label: digest} of every case's outputs, through the kernels'
    wrappers (kernel=True: each launch, twice where the case says so and
    then with the same bits) or their plain versions; adds each kernel's
    wall seconds to `seconds` (a dict) where given.  Two launches with
    different bits raise, or add the case's label to `unstable` where
    given."""
    import torch
    out = {}
    t0 = time.monotonic()
    for case in (kernel_cases(dev, large, inputs) if cases is None
                 else cases):
        args = case.build()
        got = case.run(kernel, args)
        if kernel and case.twice:
            again = case.run(kernel, args)
            if any(not torch.equal(a, b) for a, b in zip(got, again)):
                if unstable is None:
                    raise RuntimeError(f"{case.label}: two launches gave "
                                       f"different bits")
                unstable.append(case.label)
        out[case.label] = digest(got)
        if seconds is not None:
            now = time.monotonic()
            family = case.label.split()[0]
            seconds[family] = seconds.get(family, 0.0) + now - t0
            t0 = now
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out

# ---------------------------------------------------------------- the CLI


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def cli_runs(tmp: str) -> list[tuple]:
    """(label, env, argv, [(output, expected)]) of the fixture runs; an
    expected path under tmp is made by the same argv with HOST_ENV."""
    gc = _tests_module("golden_cases")
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    g = lambda n: os.path.join(GOLD, n)  # noqa: E731
    o = lambda n: os.path.join(tmp, n)  # noqa: E731
    runs = []
    for mode, env in gc.MODES.items():
        runs += [
            (f"scoreChain ({mode})", env,
             ["scoreChain", f("synthetic.chain"), f("target.2bit"),
              f("query.2bit"), o("score.chain"), "-linearGap=loose"],
             [(o("score.chain"), g("scoreChain.loose.chain"))]),
            (f"chainNet -rescore ({mode})", env,
             ["chainNet", f("synthetic.scored.sorted.chain"),
              f("target.chrom.sizes"), f("query.chrom.sizes"), o("t.net"),
              o("q.net"), "-rescore", "-tNibDir=" + f("target.2bit"),
              "-qNibDir=" + f("query.2bit"), "-linearGap=loose"],
             [(o("t.net"), g("chainNetRescore.target.net")),
              (o("q.net"), g("chainNetRescore.query.net"))]),
            (f"chainCleaner ({mode})", env,
             ["chainCleaner", f("synthetic.scored.sorted.chain"),
              f("target.2bit"), f("query.2bit"), o("clean.chain"),
              o("clean.bed"), "-tSizes=" + f("target.chrom.sizes"),
              "-qSizes=" + f("query.chrom.sizes"), "-linearGap=loose",
              "-verbose=0"],
             [(o("clean.chain"), g("chainCleaner.out.chain")),
              (o("clean.bed"), g("chainCleaner.removedSuspects.bed"))]),
        ]
    rf = ["RepeatFiller", "-c", f("repeatfiller_input.chain"),
          "-T2", f("target.2bit"), "-Q2", f("query.2bit"), "-o"]
    pc = ["patchChain", f("repeatfiller_input.chain"), f("target.2bit"),
          f("query.2bit"), f("target.chrom.sizes"), f("query.chrom.sizes")]
    runs.append(("RepeatFiller --refQuirks", {},
                 rf + [o("rfq.chain"), "--refQuirks"],
                 [(o("rfq.chain"), g("repeatfiller_reference_output.chain"))]))
    for label, argv, name in (("RepeatFiller", rf, "rf.chain"),
                              ("patchChain", pc, "pc.psl"),
                              ("patchChain -unmask", pc, "pcu.psl")):
        extra = ["-unmask"] if label.endswith("-unmask") else []
        runs.append((label, {}, argv + [o(name)] + extra,
                     [(o(name), o("host." + name))]))
    return runs


HOST_ENV = {"GAT_RESCORE": "hostnative", "GAT_BAND": "host"}


def run_cli(tmp: str, device: str) -> dict:
    """{label: "ok" or what differs} of the fixture runs through the port's
    CLI on `device`; a run whose expected output is under tmp is first made
    by the port's host paths (HOST_ENV, no device)."""
    from .cli.main import main
    gc = _tests_module("golden_cases")
    out = {}
    for label, env, argv, pairs in cli_runs(tmp):
        for _, want in pairs:
            if want.startswith(tmp):
                host_argv = [want if a == pairs[0][0] else a for a in argv]
                with gc.environ(HOST_ENV):
                    if main(host_argv) != 0:
                        raise RuntimeError(f"{label}: the host run failed")
        with gc.environ(env):
            rc = main(argv + [f"-device={device}"])
        bad = [got for got, want in pairs if not _same_bytes(got, want)]
        out[label] = ("ok" if rc == 0 and not bad
                      else f"rc {rc}, differs: {bad}")
    return out

# ---------------------------------------------------------------- the child


def foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "genomealignmenttools_tpu"
                  or m.startswith("genomealignmenttools_tpu."))


def child_main(tool: str, checker: str, device: str, out: str,
               wait_build: bool = False, large: bool = False,
               inputs: str | None = None) -> int:
    """One tool's child: the kernel cases (and for memcheck the CLI runs)
    on the copy of the kernels the checker needs (wait_build: the parent is
    building it; wait until it is up to date); writes the digests, launches
    and CLI results to `out` (JSON) and, for the builtin checker, prints
    the reports and an ERROR SUMMARY line."""
    import torch

    from . import _build
    from .device import LAUNCHES, perf_reset
    t0 = time.monotonic()
    dev = torch.device(device)
    lib = None
    if dev.type == "cuda":
        _build.use_variant(VARIANT[checker])
        deadline = time.monotonic() + TIMEOUT_S
        while wait_build and _build._stale(VARIANT[checker]):
            if time.monotonic() > deadline:
                raise RuntimeError("the kernels' build did not appear")
            time.sleep(0.2)
        lib = _build.load_library()
        if checker == "builtin":
            lib.gat_check_clear()
            lib.gat_check_arm(TOOL_BITS[tool])
    perf_reset()
    seconds = {"start": time.monotonic() - t0}
    digests, cli, unstable, error = {}, {}, [], None
    try:
        digests = run_cases(dev, True, seconds=seconds, large=large,
                            unstable=unstable, inputs=inputs)
        if tool == "memcheck" and not large:
            tc = time.monotonic()
            with tempfile.TemporaryDirectory(prefix="gat_sanitize_") as tmp:
                cli = run_cli(tmp, device)
            seconds["CLI"] = time.monotonic() - tc
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    except Exception:  # noqa: BLE001 - the parent reports it and fails
        import traceback
        error = traceback.format_exc()
        print(error, end="", flush=True)
    payload = {"tool": tool, "checker": checker, "device": str(dev),
               "launches": {k: LAUNCHES[k] for k in LAUNCH_KEYS},
               "digests": digests, "cli": cli, "checked_launches": None,
               "unstable": unstable, "error": error,
               "foreign": foreign_modules(), "section_seconds": seconds,
               "seconds": time.monotonic() - t0}
    errors = 0
    if lib is not None and checker == "builtin":
        lib.gat_check_arm(0)
        payload["checked_launches"] = int(lib.gat_check_launches())
        errors = int(lib.gat_check_errors())
        reports = lib.gat_check_reports().decode()
        if reports:
            print(reports, end="", flush=True)
    with open(out, "w") as f:
        json.dump(payload, f)
    if checker == "builtin":
        print(summary_line(errors), flush=True)
    return 1 if error else 0


def _shard(dev, shard: int, shards: int, large: bool,
           inputs: str | None = None, skip=()) -> list:
    """The cases that fall to `shard` of the plain run, those labelled in
    `skip` left out: largest cost first, each to the least loaded shard
    (shard 0, the parent, starts with the cost of its share of K2's rows),
    in case order."""
    cases = [c for c in kernel_cases(dev, large, inputs)
             if c.label not in skip]
    load = [0.0] * shards
    load[0] = 0.0 if large else 2500.0
    mine = set()
    for i in sorted(range(len(cases)), key=lambda i: -cases[i].cost):
        to = min(range(shards), key=lambda k: (load[k], k))
        load[to] += cases[i].cost
        if to == shard:
            mine.add(i)
    return [c for i, c in enumerate(cases) if i in mine]


def plain_command(shard: int, device: str, out: str, large: bool = False,
                  inputs: str | None = None,
                  skip: str | None = None) -> list[str]:
    return _module_argv("plain", "--shard", str(shard), "--shards",
                        str(PLAIN_SHARDS), "--device", device, "--out", out,
                        *(["--large"] if large else []),
                        *(["--inputs", inputs] if inputs else []),
                        *(["--skip", skip] if skip else []))


def plain_main(shard: int, shards: int, device: str, out: str,
               large: bool = False, inputs: str | None = None,
               skip: str | None = None) -> int:
    """A helper of the parent: the plain versions' digests of its shard of
    the cases (_shard; `skip`, a JSON list of labels to leave out), written
    to `out` (JSON)."""
    t0 = time.monotonic()
    if inputs:
        write_inputs(inputs, shard, shards)
    import torch
    dev = torch.device(device)
    done = ()
    if skip:
        with open(skip) as f:
            done = set(json.load(f))
    digests = run_cases(dev, False,
                        _shard(dev, shard, shards, large, inputs, done))
    with open(out, "w") as f:
        json.dump({"digests": digests, "seconds": time.monotonic() - t0}, f)
    return 0

# ---------------------------------------------------------------- the parent


def judge(tool: str, checker: str, rc: int | None, text: str,
          payload: dict | None, plain: dict, large: bool = False
          ) -> list[str]:
    """What is wrong with one child's run: its exit, its summary, its
    digests against the plain ones, its launches and CLI runs."""
    bad = []
    if rc is None:
        return [f"{tool}: the child did not finish in time"]
    if REFUSED in text:
        bad.append(f"{tool}: compute-sanitizer refused the card "
                   f"(\"{REFUSED}\")")
    try:
        errors = parse_summary(text)
        if errors:
            bad.append(f"{tool}: {errors} errors")
    except ValueError as e:
        bad.append(f"{tool}: {e}")
    if rc != 0:
        bad.append(f"{tool}: the child exited {rc}")
    if payload is None:
        return bad + [f"{tool}: the child wrote no results"]
    if payload["error"]:
        bad.append(f"{tool}: the child raised "
                   f"{payload['error'].strip().splitlines()[-1]}")
    bad += [f"{tool}: {label}: two launches gave different bits"
            for label in payload["unstable"]]
    if payload["foreign"]:
        bad.append(f"{tool}: loaded {payload['foreign']}")
    got = payload["digests"]
    if set(got) != set(plain):
        bad.append(f"{tool}: ran {len(got)} cases, the plain run "
                   f"{len(plain)}")
    bad += [f"{tool}: {label} differs from its plain version"
            for label in plain if label in got and got[label] != plain[label]]
    keys = [k for k in LAUNCH_KEYS if not (large and k in NOT_LARGE)]
    missing = [k for k in keys if not payload["launches"][k]]
    if missing:
        bad.append(f"{tool}: never launched {missing}")
    if checker == "builtin":
        total = sum(payload["launches"].values())
        if payload["checked_launches"] != total:
            bad.append(f"{tool}: {payload['checked_launches']} launches "
                       f"checked of {total}")
    if tool == "memcheck" and not large:
        if not payload["cli"]:
            bad.append("memcheck: no CLI runs")
        bad += [f"memcheck: CLI {label}: {res}"
                for label, res in payload["cli"].items() if res != "ok"]
    return bad


def _wait_all(children: dict, timeout: float) -> dict:
    """{tool: (exit code, or None where it outlived the timeout and was
    killed; seconds)} of the children."""
    deadline = time.monotonic() + timeout
    out = {}
    for tool, (proc, _, _, started) in children.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        out[tool] = (rc, time.monotonic() - started)
    return out


def run_cuda(checker: str = "compute-sanitizer", tools=TOOLS,
             timeout: float = TIMEOUT_S, device: str = "cuda",
             out_dir: str | None = None, log=print,
             large: bool = False, plain_known: dict | None = None) -> dict:
    """The kernel cases under each tool in a child process of its own, all
    side by side, and the plain digests in this process meanwhile (large:
    the cases of _large_cases instead, and no CLI runs; plain_known: plain
    digests by label that the caller computed on the same inputs).  Returns
    {"tools": {tool: {...}}, "launches": {key: n}, "failures": [...],
    "seconds": s}; raises RuntimeError on any failure."""
    import torch

    from . import _build
    t0 = time.monotonic()
    if checker not in CHECKERS:
        raise ValueError(f"unknown checker {checker!r}; one of {CHECKERS}")
    exe = find_compute_sanitizer() if checker == "compute-sanitizer" else None
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("sanitize cuda needs a CUDA card")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    own = out_dir is None
    out_dir = out_dir or tempfile.mkdtemp(prefix="gat_sanitize_")
    os.makedirs(out_dir, exist_ok=True)
    variant = VARIANT[checker]
    children: dict = {}
    build_error: list = []

    def build():
        # the children start at once and wait for this build
        try:
            tb = time.monotonic()
            if _build._stale(variant):
                _build.build(variant)
            log(f"[sanitize] kernels built with "
                f"{' '.join(_build.VARIANTS[variant])} into "
                f"{os.path.dirname(_build.lib_path(variant))}: "
                f"{time.monotonic() - tb:.3f} s")
        except Exception as e:  # noqa: BLE001 - reported below
            build_error.append(e)

    inputs = None if large else tempfile.mkdtemp(prefix="gat_sanitize_rows_")
    helper_env = dict(os.environ)
    helper_env.pop("PYTORCH_NO_CUDA_MEMORY_CACHING", None)
    helper_env["PYTHONPATH"] = child_env()["PYTHONPATH"]
    helpers: dict = {}
    known = dict(plain_known or {})
    skip = None
    if known:
        skip = os.path.join(out_dir, "plain-known.json")
        with open(skip, "w") as f:
            json.dump(sorted(known), f)
    starter = threading.Thread(target=build)
    try:
        for tool in tools:
            res = os.path.join(out_dir, f"{tool}.json")
            logf = open(os.path.join(out_dir, f"{tool}.log"), "w")
            cmd = child_command(tool, checker, str(dev), res, exe, large,
                                inputs)
            children[tool] = (subprocess.Popen(
                cmd, env=child_env(), cwd=REPO, stdout=logf,
                stderr=subprocess.STDOUT), logf, res, time.monotonic())
        for shard in range(1, PLAIN_SHARDS):
            res = os.path.join(out_dir, f"plain-{shard}.json")
            logf = open(os.path.join(out_dir, f"plain-{shard}.log"), "w")
            helpers[shard] = (subprocess.Popen(
                plain_command(shard, str(dev), res, large, inputs, skip),
                env=helper_env, cwd=REPO, stdout=logf,
                stderr=subprocess.STDOUT), logf, res, time.monotonic())
        starter.start()
        tp = time.monotonic()
        if inputs:
            write_inputs(inputs, 0, PLAIN_SHARDS)
        plain = run_cases(dev, False, _shard(dev, 0, PLAIN_SHARDS, large,
                                             inputs, known))
        helper_secs = [time.monotonic() - tp]
        plain.update(known)
        for shard, (rc, _) in _wait_all(helpers, timeout).items():
            res = helpers[shard][2]
            if rc != 0 or not os.path.exists(res):
                raise RuntimeError(f"sanitize: plain helper {shard} exited "
                                   f"{rc} (log {helpers[shard][1].name})")
            with open(res) as f:
                got = json.load(f)
            plain.update(got["digests"])
            helper_secs.append(got["seconds"])
        plain_secs = time.monotonic() - tp
        starter.join()
        if build_error:
            raise RuntimeError(f"sanitize: the {variant} build of the "
                               f"kernels failed: {build_error[0]}")
        waited = _wait_all(children, timeout)
    finally:
        if inputs:
            shutil.rmtree(inputs, ignore_errors=True)
        if starter.is_alive():
            starter.join()
        for proc, logf, _, _ in (*children.values(), *helpers.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    results, failures = {}, []
    for tool, (proc, logf, res, started) in children.items():
        rc, secs = waited[tool]
        with open(logf.name) as f:
            text = f.read()
        payload = None
        if os.path.exists(res):
            with open(res) as f:
                payload = json.load(f)
        bad = judge(tool, checker, rc, text, payload, plain, large)
        failures += bad
        try:
            errors = parse_summary(text)
        except ValueError:
            errors = None
        launches = payload["launches"] if payload else {}
        parts = payload["section_seconds"] if payload else {}
        same = sum(payload["digests"].get(k) == v for k, v in plain.items()
                   ) if payload else 0
        results[tool] = {"errors": errors, "rc": rc, "seconds": secs,
                         "launches": launches, "parts": parts,
                         "cli": len(payload["cli"]) if payload else 0,
                         "log": logf.name}
        reports = [ln for ln in text.splitlines() if ln.startswith("=====")
                   and "SUMMARY" not in ln]
        for ln in reports[:20]:
            log(f"[sanitize] {tool}: {ln}")
        log(f"[sanitize] {tool} ({checker}): "
            f"{'no summary' if errors is None else f'{errors} errors'}; "
            f"launches checked " + ", ".join(
                f"{k} {v}" for k, v in launches.items())
            + f"; {same} of {len(plain)} cases equal to their plain "
            f"versions"
            + (f", {results[tool]['cli']} CLI runs byte-identical"
               if tool == "memcheck" and not bad else "")
            + (f"; FAILED: {'; '.join(bad)}" if bad else "")
            + f"; {secs:.3f} s (" + ", ".join(
                f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    total = {k: sum(r["launches"].get(k, 0) for r in results.values())
             for k in LAUNCH_KEYS}
    log(f"[sanitize] {len(plain) - len(known)} cases through the plain "
        f"versions, in this process and {PLAIN_SHARDS - 1} helpers, each of "
        f"which makes a share of K2's rows for all: {plain_secs:.3f} s "
        f"(each: " + ", ".join(f"{x:.1f}" for x in helper_secs) + ")"
        + (f"; {len(known)} plain digests given by the caller"
           if known else ""))
    summary = {"tools": results, "launches": total, "failures": failures,
               "plain_seconds": plain_secs, "cases": len(plain),
               "seconds": time.monotonic() - t0}
    if own and not failures:
        shutil.rmtree(out_dir, ignore_errors=True)
    if failures:
        raise RuntimeError("sanitize cuda failed: " + "; ".join(failures)
                           + f" (logs in {out_dir})")
    return summary

# ---------------------------------------------------------------- tsan


def native_sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_PKG, "native", "*.cpp")))


TSAN_FLAGS = ["-O1", "-g", "-fPIC", "-shared", "-std=c++17", "-pthread",
              "-fsanitize=thread"]


def tsan_build_command(so: str) -> list[str]:
    return ["g++", *TSAN_FLAGS, "-o", so, *native_sources()]


def tsan_runtime() -> str:
    path = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    if not os.path.isabs(path) or not os.path.exists(path):
        raise FileNotFoundError("g++ has no libtsan.so")
    return path


def tsan_env(so: str, base: dict | None = None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update({"LD_PRELOAD": tsan_runtime(),
                "TSAN_OPTIONS": "halt_on_error=0 exitcode=66",
                "GAT_THREADS": "8", "GAT_NATIVE_SO": so,
                "GAT_RESCORE": "hostnative", "CUDA_VISIBLE_DEVICES": ""})
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def tsan_child(work: str) -> int:
    """The replay of tools/tsan_check.sh through the port's engines."""
    from . import native
    from .device import PERF
    from .engines.chain_cleaner import clean_chains
    from .engines.chain_net import chain_net
    from .engines.repeat_filler import repeat_filler
    from .engines.score_chain import score_chain_file
    from .utils.bench_workload import (build_cleaner_workload,
                                       build_repeatfiller_workload)
    from .utils.verbose import set_verbosity
    lib = native.get_lib()
    so = os.environ["GAT_NATIVE_SO"]
    if lib is None or os.path.realpath(lib._name) != os.path.realpath(so):
        raise RuntimeError(f"the TSAN build {so} did not load")
    set_verbosity(0)
    m = build_cleaner_workload(os.path.join(work, "cleaner"),
                               n_scenarios=200, n_bulk=3000)
    d = os.path.join(work, "run")
    os.makedirs(d, exist_ok=True)
    steps = []
    t0 = time.monotonic()
    clean_chains(m["chain"], m["t2bit"], m["q2bit"],
                 os.path.join(d, "out.chain"), os.path.join(d, "out.bed"),
                 t_sizes=m["t_sizes"], q_sizes=m["q_sizes"],
                 linear_gap="loose")
    steps.append(("chainCleaner", time.monotonic() - t0))
    t0 = time.monotonic()
    with open(os.path.join(d, "t.net"), "w") as t_out, \
            open(os.path.join(d, "q.net"), "w") as q_out:
        chain_net(m["chain"], m["t_sizes"], m["q_sizes"], t_out, q_out,
                  rescore=True, t_2bit=m["t2bit"], q_2bit=m["q2bit"],
                  linear_gap="loose")
    steps.append(("chainNet -rescore", time.monotonic() - t0))
    t0 = time.monotonic()
    score_chain_file(m["chain"], m["t2bit"], m["q2bit"],
                     os.path.join(d, "scored.chain"), linear_gap="loose")
    steps.append(("scoreChain", time.monotonic() - t0))
    os.environ["GAT_BAND"] = "host"
    rf = build_repeatfiller_workload(os.path.join(work, "repeatfiller"),
                                     n_gaps=120)
    t0 = time.monotonic()
    repeat_filler(rf["chain"], rf["t2bit"], rf["q2bit"],
                  os.path.join(d, "rf.chain"))
    if PERF["rf_chain_python_pairs"] or not PERF["rf_chain_native_pairs"]:
        raise RuntimeError("RepeatFiller did not chain its gaps natively")
    steps.append(("RepeatFiller (hspscan + bandext + chainpairs)",
                  time.monotonic() - t0))
    for name, secs in steps:
        print(f"[tsan] {name} under TSAN: done, {secs:.3f} s", flush=True)
    print(json.dumps({"steps": dict(steps), "foreign": foreign_modules()}),
          flush=True)
    return 0


TSAN_WARNING = "WARNING: ThreadSanitizer"


def run_tsan(timeout: float = 1800, scratch: str | None = None,
             log=print) -> dict:
    """Build the TSAN library, replay the threaded paths in a child, and
    fail on any race report.  Returns {"races": 0, "seconds": ..., ...}."""
    t0 = time.monotonic()
    scratch = scratch or os.path.join(tempfile.gettempdir(),
                                      "gat_tsan_torch")
    os.makedirs(scratch, exist_ok=True)
    so = os.path.join(scratch, "libgatnative.so")
    cmd = tsan_build_command(so)
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    build_secs = time.monotonic() - t0
    log(f"[tsan] built {len(native_sources())} sources of "
        f"{os.path.relpath(os.path.join(_PKG, 'native'), REPO)} with "
        f"{' '.join(TSAN_FLAGS)}: {build_secs:.3f} s")
    t1 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "genomealignmenttools_tpu_torch.sanitize",
             "tsan-child", scratch], env=tsan_env(so), cwd=REPO,
            capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"sanitize tsan: the replay did not finish in "
                           f"{timeout} s") from e
    replay_secs = time.monotonic() - t1
    text = proc.stdout + proc.stderr
    races = text.count(TSAN_WARNING)
    with open(os.path.join(scratch, "tsan.log"), "w") as f:
        f.write(text)
    for ln in proc.stdout.splitlines():
        if ln.startswith("[tsan]"):
            log(ln)
    lines = proc.stdout.strip().splitlines()
    payload = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    failures = []
    if races or proc.returncode == 66:
        failures.append(f"{races} ThreadSanitizer reports")
    if proc.returncode != 0:
        failures.append(f"the replay exited {proc.returncode}")
    if payload is None:
        failures.append("the replay printed no result")
    elif payload["foreign"]:
        failures.append(f"the replay loaded {payload['foreign']}")
    log(f"[tsan] GAT_THREADS=8: {races} race reports; replay "
        f"{replay_secs:.3f} s, build {build_secs:.3f} s; log "
        f"{os.path.join(scratch, 'tsan.log')}")
    if failures:
        raise RuntimeError("sanitize tsan failed: " + "; ".join(failures)
                           + "\n" + text[-6000:])
    return {"races": races, "build_seconds": build_secs,
            "replay_seconds": replay_secs, "steps": payload["steps"],
            "seconds": time.monotonic() - t0}

# ---------------------------------------------------------------- main


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "genomealignmenttools_tpu_torch.sanitize")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cuda", help="the kernels under the four tools")
    c.add_argument("--checker", choices=CHECKERS,
                   default="compute-sanitizer")
    c.add_argument("--tools", default=",".join(TOOLS))
    c.add_argument("--timeout", type=float, default=TIMEOUT_S)
    c.add_argument("--device", default="cuda")
    c.add_argument("--out", default=None,
                   help="keep each child's log and results here")
    c.add_argument("--large", action="store_true",
                   help="K1 at chr1's shape and K2 on 200,000 chains only")
    t = sub.add_parser("tsan", help="the native library under TSAN")
    t.add_argument("--timeout", type=float, default=1800)
    ch = sub.add_parser("child")
    ch.add_argument("--tool", choices=TOOLS, required=True)
    ch.add_argument("--checker", choices=CHECKERS, required=True)
    ch.add_argument("--device", required=True)
    ch.add_argument("--out", required=True)
    ch.add_argument("--wait-build", action="store_true")
    ch.add_argument("--large", action="store_true")
    ch.add_argument("--inputs", default=None)
    pl = sub.add_parser("plain")
    pl.add_argument("--shard", type=int, required=True)
    pl.add_argument("--shards", type=int, required=True)
    pl.add_argument("--device", required=True)
    pl.add_argument("--out", required=True)
    pl.add_argument("--large", action="store_true")
    pl.add_argument("--inputs", default=None)
    pl.add_argument("--skip", default=None)
    tc = sub.add_parser("tsan-child")
    tc.add_argument("work")
    a = p.parse_args(argv)
    if a.cmd == "child":
        return child_main(a.tool, a.checker, a.device, a.out, a.wait_build,
                          a.large, a.inputs)
    if a.cmd == "plain":
        return plain_main(a.shard, a.shards, a.device, a.out, a.large,
                          a.inputs, a.skip)
    if a.cmd == "tsan-child":
        return tsan_child(a.work)
    try:
        if a.cmd == "cuda":
            tools = tuple(x for x in a.tools.split(",") if x)
            unknown = [x for x in tools if x not in TOOLS]
            if unknown:
                p.error(f"unknown tools {unknown}")
            run_cuda(a.checker, tools, a.timeout, a.device, a.out,
                     large=a.large)
        else:
            run_tsan(a.timeout)
    except (RuntimeError, FileNotFoundError) as e:
        print(f"[sanitize] {e}", file=sys.stderr)
        return 1
    print("[sanitize] clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
