#!/usr/bin/env python3
"""Measurements behind the designs of K1 (csrc/rescore.cu), K2
(csrc/combine.cu) and K3 (csrc/band.cu), on one CUDA card.

    python3 genomealignmenttools_tpu_torch/experiments/kernel_experiments.py \\
        [k1] [k2] [k3] [--out DIR]

Run from the root of a checkout.  Builds variants of the kernels, each
into its own library under build/experiments/, prints what ptxas reports for
each (registers, stack frame, spills), checks every variant against the
plain PyTorch version, and times them in turns with CUDA events at the main
path's shapes:

k1  the first version (experiments/rescore_v1.cu: one warp a chunk, a byte a
    lane a load), the second (experiments/rescore_v2.cu: 16-byte loads, a
    fixed group of 4, 8 or 16 lanes a chunk) and the current source (16-byte
    loads, the 32-byte units of 32 chunks dealt to the lanes in turn), on the chr1
    workload's chunks (scoreChain's two launches) and on the cleaner
    workload's (30,000 short chains and 2,000 planted scenarios).
k3  the first version (experiments/band_v1.cu: byte parents in a zeroed
    scratch, lane 0's traceback over global memory) with its torch.zeros
    timed apart, and the current source whole, without its traceback (the
    DP alone: `ok` forced to 0; the traceback's share is the difference)
    and with 2 and 4 problems a block instead of 1, on the extension problems of the
    600-gap RepeatFiller workload.
k2  the first version (experiments/combine_v1.cu: seven launches over int32
    sums, fed by the torch int8 row sums; both timed together, as the
    parent's pass ran them, and the row sums apart) and the current source
    (one launch from the int8 tiles, a chained scan with decoupled
    look-back): as it is (512 threads of 4 chunks, 4 row-sum steps in
    flight), with 256 threads of 8 chunks (its first shape) or of 4, 128 of
    16, with 2 or 8 steps in flight, and cut after its row sums (the loads
    alone, s written out; the scans and the look-back cost the difference),
    on the chr1 workload's resident tiles.  Then the other row sources on
    the same chains' combined-code and 4-bit tiles (GAT_PAIR_TILES=code,
    score4): the code entry as it is (a lookup a byte in a 256-byte shared
    table), and the 4-bit entry with its decode as it is (three byte
    permutes and a __dp4a for four nibbles) and as tried instead: two
    permutes and two __dp4a against byte masks; a 256-entry shared table of
    vals[lo] + vals[hi] a byte, one for the block (bank conflicts); the same
    table with a copy for each lane (conflict-free, 16-bit entries); each
    against the plain version, twice, and timed in turns beside the int8
    entry on the same chunks.  With --out, each K2 kernel's SASS
    instruction counts by opcode are printed (the operations a tile byte
    that chip_smoke.py's bounds count).

The variants are made by replacing one line of a copy of the source; no
switch is left in the sources.  With --out the SASS of the current K3 at
max_insert 100, of K1 and of K2 is written there (cuobjdump -sass).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "csrc")


def build_variant(name: str, source: str, edits=()) -> ctypes.CDLL:
    """nvcc one source (after the (old, new) line edits) into its own
    library; prints ptxas's counts."""
    from genomealignmenttools_tpu_torch import _build
    out_dir = os.path.join(_build.BUILD_DIR, "experiments")
    os.makedirs(out_dir, exist_ok=True)
    with open(source) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} "
                               f"times in {source}")
        text = text.replace(old, new)
    cu = os.path.join(out_dir, name + ".cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, name + ".so")
    res = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC, "-o", so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}")
    lines = res.stdout.splitlines()
    for i, line in enumerate(lines):
        if "Used" in line and "registers" in line:
            fn = next((ln for ln in reversed(lines[:i])
                       if "Compiling entry function" in ln), "")
            frame = next((ln for ln in lines[max(0, i - 2):i]
                          if "stack frame" in ln), "")
            mangled = fn.split("'")[1] if fn else ""
            at = mangled.find("kernel")
            print(f"[ptxas] {name}: {mangled[max(at - 16, 0):at + 14]}: "
                  f"{line.split(':', 1)[-1].strip()}; {frame.strip()}")
    return ctypes.CDLL(so)


def dump_sass(name: str, out_dir: str) -> None:
    from genomealignmenttools_tpu_torch import _build
    so = os.path.join(_build.BUILD_DIR, "experiments", name + ".so")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", so], capture_output=True, text=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".sass"), "w") as f:
        f.write(res.stdout or res.stderr)
    print(f"[sass] {name}: {len(res.stdout.splitlines())} lines -> "
          f"{out_dir}/{name}.sass")


def turns(variants: dict, reps: int) -> dict:
    """CUDA-event ms of every variant, measured in turns, twice over; the
    smaller of the two."""
    from chip_smoke import cuda_ms
    best: dict = {}
    for _ in range(2):
        for name, fn in variants.items():
            ms = cuda_ms(fn, reps)
            best[name] = min(ms, best.get(name, ms))
    return best


def k1_launcher(lib, lut):
    import torch
    p = ctypes.c_void_p
    lib.gat_rescore_chunks.restype = ctypes.c_int
    lib.gat_rescore_chunks.argtypes = [
        p, p, ctypes.POINTER(ctypes.c_int32), p, p, p, ctypes.c_int64, p, p]
    lut25 = (ctypes.c_int32 * 25)(*lut.reshape(-1).tolist())

    def launch(job):
        out = torch.empty(job[4].numel(), dtype=torch.int32,
                          device=job[0].device)
        err = lib.gat_rescore_chunks(
            job[0].data_ptr(), job[1].data_ptr(), lut25, job[2].data_ptr(),
            job[3].data_ptr(), job[4].data_ptr(), job[4].numel(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out
    return launch


def experiment_k1(tmp: str, out_dir: str | None) -> None:
    import torch

    from chip_smoke import main_path_chunks
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.ops import window_rescore as wr
    from genomealignmenttools_tpu_torch.utils.bench_workload import (
        build_cleaner_workload, build_workload)

    dev = torch.device("cuda", 0)
    lut = wr.checked_lut(score_scheme_default().lut)
    src = os.path.join(HERE, "rescore_v2.cu")
    libs = {"v1 (warp a chunk, byte loads)": build_variant(
        "rescore_v1", os.path.join(HERE, "rescore_v1.cu"))}
    for lanes, shift in ((4, 2), (8, 3), (16, 4)):
        libs[f"v2, {lanes} lanes a chunk"] = build_variant(
            f"rescore_g{lanes}", src,
            [("constexpr int kGroup = 8; ", f"constexpr int kGroup = {lanes}; "),
             ("constexpr int kGroupShift = 3;",
              f"constexpr int kGroupShift = {shift};")])
    libs["current (32-byte units dealt to the lanes)"] = build_variant(
        "rescore_now", os.path.join(CSRC, "rescore.cu"))
    if out_dir:
        dump_sass("rescore_now", out_dir)
    launch = {k: k1_launcher(lib, lut) for k, lib in libs.items()}
    workloads = {
        "chr1": build_workload(os.path.join(tmp, "chr1"),
                               t_size=256_000_000, n_chains=384),
        "cleaner": build_cleaner_workload(os.path.join(tmp, "cleaner"),
                                          n_scenarios=2000, n_bulk=30000)}
    for label, w in workloads.items():
        jobs = main_path_chunks(w, dev)
        n_chunks = sum(int(j[4].numel()) for j in jobs)
        n_bases = sum(int(j[4].sum()) for j in jobs)
        for job in jobs:
            want = wr.chunk_sums_plain(job[0], job[1], lut, *job[2:])
            for name, fn in launch.items():
                if not torch.equal(fn(job), want):
                    raise RuntimeError(f"K1 {name} != plain on {label}")
        ms = turns({name: (lambda fn=fn: [fn(j) for j in jobs])
                    for name, fn in launch.items()}, 20)
        bound = 1e3 * (2 * n_bases + 24 * n_chunks) / 3.35e12
        print(f"[k1] {label}: {len(jobs)} launches, {n_chunks} chunks, "
              f"{n_bases} bases ({n_bases / n_chunks:.1f} a chunk), byte "
              f"bound {bound:.4f} ms; all variants == plain; ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
        del jobs


def k3_launcher(lib, packed: bool):
    import torch

    from genomealignmenttools_tpu_torch.ops import band_batch as bb
    p = ctypes.c_void_p
    lib.gat_band_ext.restype = ctypes.c_int
    lib.gat_band_ext.argtypes = [
        p, p, p, p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p, p]

    def launch(a, batch):
        dev = a[0].device
        n_prob = a[1].numel() - 1
        if packed:
            parents = torch.empty(
                a[0].numel() * bb.parent_layout(batch.max_insert)[1],
                dtype=torch.uint8, device=dev)
        else:
            parents = torch.zeros(
                a[0].numel() * (2 * batch.max_insert + 1), dtype=torch.uint8,
                device=dev)
        centers = torch.empty(a[0].numel(), dtype=torch.int32, device=dev)
        meta = torch.empty((n_prob, 8 if packed else 6), dtype=torch.int32,
                           device=dev)
        moves = torch.zeros(a[0].numel() + a[2].numel(), dtype=torch.uint8,
                            device=dev)
        mat25 = (ctypes.c_int32 * 25)(*batch.mat.reshape(-1).tolist())
        err = lib.gat_band_ext(
            a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(),
            a[3].data_ptr(), n_prob, mat25, 0, batch.gap_open,
            batch.gap_extend, batch.max_insert, parents.data_ptr(),
            centers.data_ptr(), meta.data_ptr(), moves.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return meta[:, :6], moves
    return launch


def experiment_k3(tmp: str, out_dir: str | None) -> None:
    import torch

    from genomealignmenttools_tpu_torch.device.genome import open_genome
    from genomealignmenttools_tpu_torch.engines.repeat_filler import (
        _gap_job_regions, harvest_gap_jobs)
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.ops import band_batch as bb
    from genomealignmenttools_tpu_torch.ops.seed_extend import GapAligner
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_repeatfiller_workload

    dev = torch.device("cuda", 0)
    src = os.path.join(CSRC, "band.cu")
    no_traceback = ("  const int ok = err ? 0 : global_mode ? 1 : best > 0;",
                    "  const int ok = 0;")
    warps = "constexpr int kWarps = 1; "
    libs = {
        "v1 (byte parents, zeroed scratch)": (build_variant(
            "band_v1", os.path.join(HERE, "band_v1.cu")), False),
        "current": (build_variant("band_now", src), True),
        "current, DP alone": (build_variant("band_dp", src, [no_traceback]),
                              True),
        "current, 2 problems a block": (build_variant(
            "band_w2", src, [(warps, "constexpr int kWarps = 2; ")]), True),
        "current, 4 problems a block": (build_variant(
            "band_w4", src, [(warps, "constexpr int kWarps = 4; ")]), True),
    }
    if out_dir:
        dump_sass("band_now", out_dir)
    w = build_repeatfiller_workload(os.path.join(tmp, "rf"), n_gaps=600)
    scheme = score_scheme_default()
    aligner = GapAligner(
        scheme.lut, seed_len=6, hsp_threshold=1500, gapped_threshold=2000,
        gap_open=scheme.gap_open, gap_extend=scheme.gap_extend,
        char_matrix=scheme.char_matrix(), device=dev)
    with open(w["chain"]) as fh:
        lines = [ln + "\n" for ln in fh.read().split("\n")]
    jobs = harvest_gap_jobs(lines, 0, 0, 0, 10, 10, 100000, 100000)
    t_gen, q_gen = open_genome(w["t2bit"]), open_genome(w["q2bit"])
    probs = []
    for job in jobs:
        (t_codes, q_codes, _ts, _qs, t_lo, t_hi, q_lo,
         q_hi) = _gap_job_regions(job, t_gen, q_gen)
        probs.extend(aligner.align_prepare(t_codes, q_codes, t_lo, t_hi,
                                           q_lo, q_hi)[2])
    batch = aligner._band_batch()
    _, todo = bb.orient(probs, batch.a_max)
    a = [torch.from_numpy(x).to(dev) for x in bb.pack(todo)]
    a_cols = int(a[0].numel())
    plain = bb.band_ext_plain(*a, batch.mat, False, batch.gap_open,
                              batch.gap_extend, batch.max_insert)
    launch = {k: k3_launcher(lib, packed) for k, (lib, packed) in
              libs.items()}
    for name, fn in launch.items():
        got = fn(a, batch)
        torch.cuda.synchronize()
        if "DP alone" in name:
            same = torch.equal(got[0][:, 1:4], plain[0][:, 1:4])
        else:
            same = all(torch.equal(g, p) for g, p in zip(got, plain))
        if not same:
            raise RuntimeError(f"K3 {name} != plain")
    band = 2 * batch.max_insert + 1
    variants = {name: (lambda fn=fn: fn(a, batch))
                for name, fn in launch.items()}
    variants["torch.zeros of v1's parent scratch"] = lambda: torch.zeros(
        a_cols * band, dtype=torch.uint8, device=dev)
    variants["torch.empty + zeros of meta and moves (current)"] = lambda: (
        torch.empty(a_cols * bb.parent_layout(batch.max_insert)[1],
                    dtype=torch.uint8, device=dev),
        torch.zeros(a_cols + int(a[2].numel()), dtype=torch.uint8,
                    device=dev))
    ms = turns(variants, 5)
    print(f"[k3] 600 gaps: {len(todo)} problems, {a_cols} columns of {band} "
          f"cells; every variant == plain (the DP alone: best, a_best, "
          f"b_best); ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))


def k2_launcher(lib):
    """The current K2's tile entry from a variant's library: (c, w)."""
    import torch
    p = ctypes.c_void_p
    lib.gat_pair_combine_tiles.restype = ctypes.c_int
    lib.gat_pair_combine_tiles.argtypes = [
        p, ctypes.c_int, p, p, p, ctypes.c_int64, p, p, p, p]
    lib.gat_pair_combine_scratch.restype = ctypes.c_int64
    lib.gat_pair_combine_scratch.argtypes = [ctypes.c_int64]

    def launch(tiles, bias, flags):
        m = bias.numel()
        c = torch.empty(m, dtype=torch.int32, device=bias.device)
        w = torch.empty_like(c)
        scratch = torch.zeros(lib.gat_pair_combine_scratch(m),
                              dtype=torch.int64, device=bias.device)
        err = lib.gat_pair_combine_tiles(
            tiles.data_ptr(), tiles.shape[1], None, bias.data_ptr(),
            flags.data_ptr(), m, c.data_ptr(), w.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return c, w
    return launch


def k2_format_launcher(lib, kind: str, table):
    """The code or 4-bit K2 entry from a variant's library: (c, w)."""
    import numpy as np
    import torch
    p = ctypes.c_void_p
    entry = getattr(lib, f"gat_pair_combine_{kind}")
    entry.restype = ctypes.c_int
    entry.argtypes = [p, ctypes.c_int, ctypes.POINTER(ctypes.c_int8), p, p,
                      p, ctypes.c_int64, p, p, p, p]
    lib.gat_pair_combine_scratch.restype = ctypes.c_int64
    lib.gat_pair_combine_scratch.argtypes = [ctypes.c_int64]
    host = np.ascontiguousarray(table.numpy(), np.int8)

    def launch(tiles, bias, flags):
        m = bias.numel()
        c = torch.empty(m, dtype=torch.int32, device=bias.device)
        w = torch.empty_like(c)
        scratch = torch.zeros(lib.gat_pair_combine_scratch(m),
                              dtype=torch.int64, device=bias.device)
        err = entry(tiles.data_ptr(), tiles.shape[1],
                    host.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), None,
                    bias.data_ptr(), flags.data_ptr(), m, c.data_ptr(),
                    w.data_ptr(), scratch.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return c, w
    return launch


# the 4-bit decode as it is, and the variants tried in its place
SCORE4_WORD = """  __device__ int32_t word(uint32_t w, int32_t acc) const {
    acc = __dp4a(static_cast<int32_t>(vals4(w)), 0x01010101, acc);
    return __dp4a(static_cast<int32_t>(vals4(w >> 16)), 0x01010101, acc);
  }"""
SCORE4_PREPARE = "  uint32_t p[4];\n  __device__ void prepare() const {}"
# the value of nibble n, sign-extended, from the four packed words
_NIB = ("static_cast<int32_t>(static_cast<int8_t>(__byte_perm(p[n >> 3 << 1],"
        " p[(n >> 3 << 1) + 1], n & 7)))")
SCORE4_VARIANTS = {
    "two permutes, two __dp4a against byte masks": [(SCORE4_WORD, """  \
__device__ int32_t word(uint32_t w, int32_t acc) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t s = h ? w >> 16 : w;
      const uint32_t sel = s & 0x7777u;
      const uint32_t hi = __byte_perm(0u, 0x01010101u, (s >> 1) & 0x4444u);
      acc = __dp4a(static_cast<int32_t>(__byte_perm(p[0], p[1], sel)),
                   static_cast<int32_t>(hi ^ 0x01010101u), acc);
      acc = __dp4a(static_cast<int32_t>(__byte_perm(p[2], p[3], sel)),
                   static_cast<int32_t>(hi), acc);
    }
    return acc;
  }""")],
    "a shared table of pair sums, one for the block": [
        (SCORE4_PREPARE, """  uint32_t p[4];
  __device__ void prepare() const {
    for (int b = threadIdx.x; b < 256; b += kThreads) {
      int n = b & 15;
      int32_t v = %s;
      n = b >> 4;
      pair_sum[b] = v + %s;
    }
    __syncthreads();
  }""" % (_NIB, _NIB)),
        (SCORE4_WORD, """  __device__ int32_t word(uint32_t w, int32_t acc) const {
    return acc + pair_sum[w & 0xff] + pair_sum[(w >> 8) & 0xff] +
           pair_sum[(w >> 16) & 0xff] + pair_sum[w >> 24];
  }"""),
        ("// 4-bit score indices", "__shared__ int32_t pair_sum[256];\n\n"
         "// 4-bit score indices")],
    "a shared table of pair sums, a copy a lane": [
        (SCORE4_PREPARE, """  uint32_t p[4];
  __device__ void prepare() const {
    for (int i = threadIdx.x; i < 256 * 32; i += kThreads) {
      const int b = i >> 5;
      int n = b & 15;
      int32_t v = %s;
      n = b >> 4;
      // entry b of lane l at 16-bit slot ((b >> 1) * 32 + l) * 2 + (b & 1):
      // lane l's words all lie in bank l
      lane_sum[((b >> 1) * 32 + (i & 31)) * 2 + (b & 1)] =
          static_cast<int16_t>(v + %s);
    }
    __syncthreads();
  }""" % (_NIB, _NIB)),
        (SCORE4_WORD, """  __device__ int32_t word(uint32_t w, int32_t acc) const {
    const int16_t* t = lane_sum + 2 * (threadIdx.x & 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = (w >> (8 * k)) & 0xff;
      acc += t[(b >> 1) * 64 + (b & 1)];
    }
    return acc;
  }"""),
        ("// 4-bit score indices", "__shared__ int16_t lane_sum[256 * 32];"
         "\n\n// 4-bit score indices")],
}


def sass_counts(name: str, out_dir: str) -> None:
    """Per K2 kernel in a dumped library: its instruction count and the
    count of each opcode, the most frequent first; for the 16-byte-load row
    sources, the row-sum loop (the loop around the streaming 128-bit loads,
    LDG.E.EF.128): its instructions, the tile bytes a thread reads in one
    trip, and their ratio, the integer operations a tile byte that
    chip_smoke.py's bounds count."""
    import collections
    import re
    path = os.path.join(out_dir, name + ".sass")
    with open(path) as f:
        text = f.read()
    for block in text.split("Function : ")[1:]:
        fn = block.split("\n", 1)[0].strip()
        if "combine_kernel" not in fn:
            continue
        ins = [(int(a, 16), op, arg) for a, op, arg in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T] )?([A-Z0-9_.]+)"
            r"([^;]*);", block)]
        ops = collections.Counter(op for _, op, _ in ins)
        src = next((k for k in ("Score8", "Code", "Score4", "SumsGiven")
                    if k in fn), fn[:40])
        shape = "RowsVec" if "RowsVec" in fn else (
            "RowsAny" if "RowsAny" in fn else "")
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common(10))
        loop = ""
        for addr, op, arg in ins:
            target = re.search(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                body = [o for a, o, _ in ins
                        if int(target.group(1), 16) <= a <= addr]
                loads = body.count("LDG.E.EF.128")
                if loads:
                    loop = (f"; row-sum loop {len(body)} instructions for "
                            f"{16 * loads} tile bytes a thread: "
                            f"{len(body) / (16 * loads):.3f} a byte")
        print(f"[sass] {name}: {src} {shape}: {sum(ops.values())} "
              f"instructions: {top}{loop}")


def experiment_k2(tmp: str, out_dir: str | None) -> None:
    import torch

    from chip_smoke import bind_v1, v1_pass
    from genomealignmenttools_tpu_torch.device.genome import open_genome
    from genomealignmenttools_tpu_torch.formats.chain import read_chains
    from genomealignmenttools_tpu_torch.formats.gapcalc import \
        gap_calc_from_file
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.ops import pair_combine as pc
    from genomealignmenttools_tpu_torch.ops.pair_rescore import \
        TorchPairChainScorer
    from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_workload

    dev = torch.device("cuda", 0)
    src = os.path.join(CSRC, "combine.cu")
    threads = "constexpr int kThreads = 512;"
    items = "constexpr int kItems = 4; "
    unroll = "constexpr int kUnroll = 4; "
    cut = ("  rows.load(sh.s, base, n);\n  GAT_SYNCTHREADS();\n",
           "  rows.load(sh.s, base, n);\n  GAT_SYNCTHREADS();\n"
           "  for (int i = threadIdx.x; i < n; i += kThreads) "
           "c_out[base + i] = sh.s[i];\n  if (n > 0) return;\n")
    v1 = bind_v1(build_variant("combine_v1",
                               os.path.join(HERE, "combine_v1.cu")))
    libs = {"current (512 threads, 4 chunks a thread, 4 steps in flight)":
            build_variant("combine_now", src)}
    for n, k in ((256, 8), (256, 4), (128, 16)):
        libs[f"{n} threads, {k} chunks a thread"] = build_variant(
            f"combine_t{n}_i{k}", src,
            [(threads, f"constexpr int kThreads = {n};"),
             (items, f"constexpr int kItems = {k}; ")])
    for u in (2, 8):
        libs[f"{u} row-sum steps in flight"] = build_variant(
            f"combine_u{u}", src, [(unroll, f"constexpr int kUnroll = {u}; ")])
    cut_lib = build_variant("combine_rowsums", src, [cut])
    if out_dir:
        dump_sass("combine_now", out_dir)
    w = build_workload(os.path.join(tmp, "chr1"), t_size=256_000_000,
                       n_chains=384)
    scheme, gc = score_scheme_default(), gap_calc_from_file("loose")
    chains = read_chains(w["chain"])
    scorer = TorchChainScorer(scheme, gc, open_genome(w["t2bit"]),
                              open_genome(w["q2bit"]), device=dev, mode="pair")
    jobs, order = scorer._grouped(chains)
    meta = TorchPairChainScorer(scorer._dev, gc)._meta(
        jobs, [chains[i].n_blocks for i in order])
    tiles, bias, flags = scorer._dev._pack(jobs).tiles, meta.bias, meta.flags
    want = pc.pair_combine_scan_tiles_plain(tiles, bias, flags)
    launch = {k: k2_launcher(lib) for k, lib in libs.items()}
    for name, fn in launch.items():
        for _ in range(2):
            got = fn(tiles, bias, flags)
            if not all(torch.equal(g, x) for g, x in zip(got, want)):
                raise RuntimeError(f"K2 {name} != plain")
    if not all(torch.equal(g, x) for g, x in
               zip(v1_pass(v1, tiles, bias, flags), want)):
        raise RuntimeError("K2 v1 != plain")
    sums_only = k2_launcher(cut_lib)
    if not torch.equal(sums_only(tiles, bias, flags)[0],
                       tiles.sum(dim=1, dtype=torch.int32)):
        raise RuntimeError("K2 cut after its row sums: s != the row sums")
    variants = {"v1 + torch row sums (parent's pass)":
                lambda: v1_pass(v1, tiles, bias, flags),
                "torch row sums alone": lambda: tiles.sum(
                    dim=1, dtype=torch.int32)}
    variants.update({name: (lambda fn=fn: fn(tiles, bias, flags))
                     for name, fn in launch.items()})
    variants["current, cut after its row sums"] = lambda: sums_only(
        tiles, bias, flags)
    variants["torch.zeros of the scratch alone"] = lambda: torch.zeros(
        1 + 3 * -(-bias.numel() // pc.TILE), dtype=torch.int64, device=dev)
    ms = turns(variants, 20)
    rows = tiles.shape[0]
    bound = 1e3 * (tiles.numel() + 16 * rows) / 3.35e12
    print(f"[k2] chr1 resident: {rows} chunks of {tiles.shape[1]} bytes, byte "
          f"bound {bound:.4f} ms; every variant == plain, twice; ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    if out_dir:
        sass_counts("combine_now", out_dir)

    # the other row sources on the same chains
    int8_launch = launch["current (512 threads, 4 chunks a thread, 4 steps "
                         "in flight)"]
    libs4 = {"permutes (current)": libs["current (512 threads, 4 chunks a "
                                        "thread, 4 steps in flight)"]}
    for i, (name, edits) in enumerate(SCORE4_VARIANTS.items()):
        libs4[name] = build_variant(f"combine_s4_{i}", src, edits)
        if out_dir:
            dump_sass(f"combine_s4_{i}", out_dir)
            sass_counts(f"combine_s4_{i}", out_dir)
    saved = os.environ.get("GAT_PAIR_TILES")
    try:
        for kind in ("code", "score4"):
            os.environ["GAT_PAIR_TILES"] = kind
            fmt = TorchChainScorer(scheme, gc, open_genome(w["t2bit"]),
                                   open_genome(w["q2bit"]), device=dev,
                                   mode="pair")
            pack = fmt._dev._pack(fmt._grouped(chains)[0])
            if pack.tiles.shape[0] != rows:
                raise RuntimeError(f"{kind} tiles have other rows")
            want = pc.pair_combine_scan_tiles_plain(
                pack.tiles, bias, flags, None, kind, pack.table)
            chosen = libs4 if kind == "score4" else {
                "lookup (current)": libs4["permutes (current)"]}
            fns = {name: k2_format_launcher(lib, kind, pack.table)
                   for name, lib in chosen.items()}
            for name, fn in fns.items():
                for _ in range(2):
                    got = fn(pack.tiles, bias, flags)
                    if not all(torch.equal(g, x) for g, x in zip(got, want)):
                        raise RuntimeError(f"K2 {kind} {name} != plain")
            variants = {"int8 entry, same chunks":
                        lambda: int8_launch(tiles, bias, flags)}
            variants.update({name: (lambda fn=fn, t=pack.tiles: fn(
                t, bias, flags)) for name, fn in fns.items()})
            ms = turns(variants, 20)
            n_bytes = pack.tiles.numel() + 16 * rows
            print(f"[k2 {kind}] chr1 resident: {rows} chunks of "
                  f"{pack.tiles.shape[1]} bytes, byte bound "
                  f"{1e3 * n_bytes / 3.35e12:.4f} ms; every variant == "
                  f"plain, twice; ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
            del fmt, pack, want
    finally:
        if saved is None:
            os.environ.pop("GAT_PAIR_TILES", None)
        else:
            os.environ["GAT_PAIR_TILES"] = saved


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_experiments: needs a CUDA card")
    out_dir = None
    if "--out" in argv:
        out_dir = argv[argv.index("--out") + 1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] {smi}")
    which = [a for a in argv if a in ("k1", "k2", "k3")] or ["k1", "k2", "k3"]
    with tempfile.TemporaryDirectory(prefix="kernel_experiments_") as tmp:
        t0 = time.monotonic()
        if "k3" in which:
            experiment_k3(tmp, out_dir)
        if "k1" in which:
            experiment_k1(tmp, out_dir)
        if "k2" in which:
            experiment_k2(tmp, out_dir)
        print(f"[done] {time.monotonic() - t0:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
