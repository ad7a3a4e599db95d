#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's rescoring path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  Phases,
each reported on its own lines; any failure raises and the script exits
non-zero:

1. device   - require CUDA; print the card's name and nvidia-smi's
              name and power limit.
2. build    - build the kernels from genomealignmenttools_tpu_torch/csrc
              with nvcc (sm_90a) and print the build seconds and ptxas
              counts.
3. kernel   - K1 against its plain PyTorch version on the card, exact, on
              seeded random genomes with N runs, both strands, chunk lengths
              0, 1, 255 and 256 and chunks that end at the genome's end.
4. fixtures - scoreChain, chainNet -rescore and chainCleaner through the
              port's CLI on the card, byte-compared with tests/golden; each
              must launch K1.
5. chr1     - the bench workload (utils/bench_workload.py, 256 Mb per genome,
              384 chains, ~367 Mb aligned) through the port's scoreChain,
              byte-compared with a host-native run of the same file; cold and
              warm seconds, Mb aligned per second, K1 launches, and K1's time
              against the plain version's at the main path's shapes.

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {"platform": "gpu", ...}}.  Imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(REPO, "tests", "fixtures")
GOLD = os.path.join(REPO, "tests", "golden")
KERNEL = "rescore_chunks"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from genomealignmenttools_tpu_torch import _build
    t0 = time.monotonic()
    _build.load_library()
    secs = time.monotonic() - t0
    built = _build.last_build_seconds
    print(f"[build] {_build.LIB_PATH}: "
          + (f"built in {built:.3f} s" if built is not None else
             f"up to date, loaded in {secs:.3f} s"))
    with open(_build.LOG_PATH) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")


def random_case(rng, t_len: int, q_len: int, n: int):
    """Seeded genomes (codes 0..3 with N runs) and chunk descriptors with
    the edge cases: lengths 0, 1, 255, 256 and chunks at the genome end."""
    import numpy as np

    from genomealignmenttools_tpu.device.genome import revcomp_codes
    from genomealignmenttools_tpu_torch.ops.window_rescore import CHUNK

    def genome(size):
        codes = rng.integers(0, 4, size).astype(np.uint8)
        for s in rng.integers(0, size, 50):
            codes[s:s + int(rng.integers(1, 600))] = 4
        return codes

    t = genome(t_len)
    q_plus = genome(q_len)
    length = rng.integers(0, CHUNK + 1, n).astype(np.int32)
    length[:8] = [0, 1, 255, 256, 256, 0, 1, 255]
    t_off = (rng.integers(0, t_len - CHUNK, n)).astype(np.int64)
    q_off = (rng.integers(0, q_len - CHUNK, n)).astype(np.int64)
    t_off[4], q_off[4] = t_len - 256, q_len - 256    # end at the genome end
    t_off[5], q_off[5] = t_len, q_len                # empty, at the end
    t_off[6], q_off[6] = t_len - 1, q_len - 1
    return t, q_plus, revcomp_codes(q_plus), t_off, q_off, length


def phase_kernel(dev) -> int:
    """Exact kernel == plain on the card; returns the max abs difference."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu_torch.ops import window_rescore as wr
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default

    lut = wr.checked_lut(score_scheme_default().lut)
    rng = np.random.default_rng(20261016)
    t, q_plus, q_minus, t_off, q_off, length = random_case(
        rng, 3_000_017, 2_000_003, 400_000)
    worst = 0
    for strand, q in (("+", q_plus), ("-", q_minus)):
        host = [torch.from_numpy(a) for a in (t, q, t_off, q_off, length)]
        card = [a.to(dev) for a in host]
        got = wr.chunk_sums(card[0], card[1], lut, *card[2:])
        want = wr.chunk_sums_plain(card[0], card[1], lut, *card[2:])
        torch.cuda.synchronize()
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        check(diff == 0, f"kernel != plain on strand {strand} (max {diff})")
        cpu = wr.chunk_sums(host[0], host[1], lut, *host[2:])
        check(torch.equal(cpu, got.cpu()), f"CPU plain != kernel ({strand})")
    # a chunk outside the genome raises instead of reading past the end
    bad = torch.tensor([len(t)], dtype=torch.int64, device=dev)
    one = torch.tensor([1], dtype=torch.int32, device=dev)
    try:
        wr.chunk_sums(card[0], card[1], lut, bad, bad * 0, one)
    except IndexError:
        pass
    else:
        raise RuntimeError("chip_smoke: out-of-range chunk was not refused")
    print(f"[kernel] {2 * len(length)} chunks, both strands: kernel == "
          f"plain exactly (max abs diff {worst})")
    return worst


def run_cli(args: list[str]) -> dict:
    """One port CLI run on the card; returns the launch counts of it."""
    import torch

    from genomealignmenttools_tpu_torch.cli.main import main
    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    perf_reset()
    rc = main(args + ["-device=cuda"])
    torch.cuda.synchronize()
    check(rc == 0, f"CLI {args[0]} exited {rc}")
    return dict(LAUNCHES)


def phase_fixtures(tmp: str) -> None:
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    g = lambda n: os.path.join(GOLD, n)  # noqa: E731
    o = lambda n: os.path.join(tmp, n)  # noqa: E731
    runs = [
        ("scoreChain",
         ["scoreChain", f("synthetic.chain"), f("target.2bit"),
          f("query.2bit"), o("score.chain"), "-linearGap=loose"],
         [(o("score.chain"), g("scoreChain.loose.chain"))]),
        ("chainNet -rescore",
         ["chainNet", f("synthetic.scored.sorted.chain"),
          f("target.chrom.sizes"), f("query.chrom.sizes"), o("t.net"),
          o("q.net"), "-rescore", "-tNibDir=" + f("target.2bit"),
          "-qNibDir=" + f("query.2bit"), "-linearGap=loose"],
         [(o("t.net"), g("chainNetRescore.target.net")),
          (o("q.net"), g("chainNetRescore.query.net"))]),
        ("chainCleaner",
         ["chainCleaner", f("synthetic.scored.sorted.chain"),
          f("target.2bit"), f("query.2bit"), o("clean.chain"),
          o("clean.bed"), "-tSizes=" + f("target.chrom.sizes"),
          "-qSizes=" + f("query.chrom.sizes"), "-linearGap=loose",
          "-verbose=0"],
         [(o("clean.chain"), g("chainCleaner.out.chain")),
          (o("clean.bed"), g("chainCleaner.removedSuspects.bed"))]),
    ]
    for label, args, pairs in runs:
        t0 = time.monotonic()
        launches = run_cli(args)[KERNEL]
        secs = time.monotonic() - t0
        check(launches > 0, f"{label} never launched {KERNEL}")
        for got, want in pairs:
            check(same_bytes(got, want), f"{label}: {got} != {want}")
        print(f"[fixtures] {label}: byte-identical to "
              f"{', '.join(os.path.basename(w) for _, w in pairs)}; "
              f"{KERNEL} launches {launches}; {secs:.3f} s")


class HostNativeScorer:
    """The reference's all-host scoring of a whole table
    (DeviceChainScorer._score_table_native, ops/rescore.py:521-534) without
    the class that imports jax: gat_subset_scores over full-cover jobs."""

    def __init__(self, scheme, gap_calc, t_genome, q_genome):
        self.scheme, self.gap_calc = scheme, gap_calc
        self.t_genome, self.q_genome = t_genome, q_genome

    def score_table(self, table):
        import numpy as np

        from genomealignmenttools_tpu.native import get_lib
        from genomealignmenttools_tpu.ops.rescore import (
            lut25_of, native_subset_scores, table_row_code_ptrs)
        n = len(table)
        sel = np.arange(n)
        t_ptrs, q_ptrs, keepalive = table_row_code_ptrs(
            table, sel, self.t_genome, self.q_genome)
        jobs = np.stack([sel, table.header[:, 1], table.header[:, 2]], 1)
        out = native_subset_scores(
            get_lib(), table.blocks, table.block_offsets, t_ptrs, q_ptrs,
            lut25_of(self.scheme.lut), self.gap_calc,
            np.ascontiguousarray(jobs, np.int64))
        del keepalive
        return out[:, :3].astype(np.float64)


def main_path_chunks(meta: dict, dev):
    """The chunk descriptors the port's scoreChain builds for this chain
    file: one job per (t, q, strand) group, rows in file order."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu.device.genome import open_genome
    from genomealignmenttools_tpu.native.chain_io import parse_chain_table
    from genomealignmenttools_tpu_torch.ops.window_rescore import chunk_blocks
    with open(meta["chain"], "rb") as f:
        table = parse_chain_table(f.read())
    (t_ids, t_names), (q_ids, q_names) = table.names_factorized()
    t_gen, q_gen = open_genome(meta["t2bit"]), open_genome(meta["q2bit"])
    bo = table.block_offsets
    jobs = []
    for key in sorted(set(zip(t_ids.tolist(), q_ids.tolist(),
                              table.strands.tolist()))):
        rows = np.flatnonzero((t_ids == key[0]) & (q_ids == key[1])
                              & (table.strands == key[2]))
        blocks = np.concatenate([table.blocks[bo[r]:bo[r + 1]]
                                 for r in rows])
        t_off, q_off, length, _ = chunk_blocks(blocks)
        strand = chr(key[2])
        jobs.append([torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            t_gen.codes(t_names[key[0]], "+"),
            q_gen.codes(q_names[key[1]], strand), t_off, q_off, length)])
    return jobs


def phase_chr1(tmp: str, dev) -> tuple[dict, int]:
    import torch

    from genomealignmenttools_tpu.engines.score_chain import score_chain_file
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu.utils.bench_workload import build_workload
    from genomealignmenttools_tpu.utils.profiling import (phase_acc_start,
                                                         phase_acc_stop)
    from genomealignmenttools_tpu_torch.ops import window_rescore as wr

    t0 = time.monotonic()
    meta = build_workload(os.path.join(tmp, "chr1"), t_size=256_000_000,
                          n_chains=384)
    mb = meta["aligned_bases"] / 1e6
    print(f"[chr1] workload: 256 Mb per genome, 384 chains, {mb:.3f} Mb "
          f"aligned; built in {time.monotonic() - t0:.3f} s (set-up)")
    args = ["scoreChain", meta["chain"], meta["t2bit"], meta["q2bit"],
            os.path.join(tmp, "chr1.dev.chain"), "-linearGap=loose"]
    torch.cuda.reset_peak_memory_stats()
    times, launches = {}, None
    for label in ("cold", "warm"):
        phase_acc_start()
        t0 = time.monotonic()
        counts = run_cli(args)   # counts reset just before, read just after
        times[label] = time.monotonic() - t0
        phases = phase_acc_stop()
        launches = counts[KERNEL] if launches is None else launches
        check(counts[KERNEL] > 0, f"chr1 scoreChain ({label}) never "
                                  f"launched {KERNEL}")
        other = times[label] - phases.get("read chains", 0.0) \
            - phases.get("score chains", 0.0)
        print(f"[chr1] port scoreChain {label}: {times[label]:.3f} s, "
              f"{mb / times[label]:.3f} Mb aligned/s, {KERNEL} launches "
              f"{counts[KERNEL]}; phases "
              + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items())
              + f"; outside both phases (set-up, write) {other:.4f} s")
    print(f"[chr1] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    host_out = os.path.join(tmp, "chr1.host.chain")
    t0 = time.monotonic()
    score_chain_file(meta["chain"], meta["t2bit"], meta["q2bit"], host_out,
                     linear_gap="loose", scorer_factory=HostNativeScorer)
    host_s = time.monotonic() - t0
    check(same_bytes(args[4], host_out),
          "chr1 port scoreChain differs from the host-native run")
    print(f"[chr1] byte-identical to the host-native run "
          f"(host-native, decoded genomes warm: {host_s:.3f} s, "
          f"{mb / host_s:.3f} Mb aligned/s)")

    lut = wr.checked_lut(score_scheme_default().lut)
    jobs = main_path_chunks(meta, dev)
    worst = 0
    for job in jobs:
        got = wr.chunk_sums(job[0], job[1], lut, *job[2:])
        want = wr.chunk_sums_plain(job[0], job[1], lut, *job[2:])
        worst = max(worst, int((got.to(torch.int64)
                                - want.to(torch.int64)).abs().max()))
    check(worst == 0, f"kernel != plain at chr1 shapes (max {worst})")
    del got, want
    n_chunks = sum(int(j[4].numel()) for j in jobs)
    ms = {}
    # plain, kernel, kernel, plain: compare within one call, in turns
    for label, fn, reps in (
            ("plain", wr.chunk_sums_plain, 2), ("kernel", wr._launch_kernel, 20),
            ("kernel", wr._launch_kernel, 20), ("plain", wr.chunk_sums_plain, 2),
            ("wrapper", wr.chunk_sums, 20)):
        t = sum(cuda_ms(lambda j=j: fn(j[0], j[1], lut, *j[2:]), reps)
                for j in jobs)
        ms.setdefault(label, []).append(t)
    print(f"[chr1] K1 at main-path shapes ({len(jobs)} launches, {n_chunks} "
          f"chunks, {mb:.3f} Mb): kernel {ms['kernel']} ms, plain "
          f"{ms['plain']} ms, wrapper with bounds check {ms['wrapper']} ms; "
          f"kernel == plain exactly")
    entry = {"name": KERNEL, "route": "cuda",
             "source": "genomealignmenttools_tpu_torch/csrc/rescore.cu",
             "replaces": "genomealignmenttools_tpu/ops/pallas_rescore.py:43",
             "launches": launches, "max_abs_err": worst,
             "ms": min(ms["kernel"]), "plain_ms": min(ms["plain"])}
    return entry, worst


def main() -> int:
    name, smi = phase_device()
    import torch
    dev = torch.device("cuda", 0)
    phase_build()
    worst = phase_kernel(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_fixtures(tmp)
        entry, worst_chr1 = phase_chr1(tmp, dev)
    entry["max_abs_err"] = max(worst, worst_chr1)
    jax_like = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m.startswith("genomealignmenttools_tpu.ops.pa")
                      or m.startswith("genomealignmenttools_tpu.parallel"))
    check(not jax_like, f"jax-backed modules were loaded: {jax_like}")
    print("[jax] no jax and no jax-backed module of the reference was loaded")
    print(smi)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
