#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's rescoring, gap-filling and multi-device
paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  Phases,
each reported on its own lines; any failure raises and the script exits
non-zero:

1. device   - require CUDA; print the card's name and nvidia-smi's
              name and power limit.
2. build    - build the kernels from genomealignmenttools_tpu_torch/csrc
              with nvcc (sm_90a, one nvcc per source, in parallel) and
              print the build seconds and ptxas counts.
3. kernel   - K1 against its plain PyTorch version on the card, exact, on
              seeded random genomes with N runs, both strands, chunk lengths
              0, 1, 255 and 256 and chunks that end at the genome's end.
4. kernel K2 - K2 against its plain version on the card, exact, and K2 +
              finish against the staged int64 combine, on the adversarial
              chain workloads of tests/combine_cases.py: the carry's edge
              cases (a chain over more than three of K2's tiles, single-chunk
              chains, a chain ending on a tile's last chunk, pad chunks), an
              unpadded input, and 7, 800 and 200,000 random chains.
5. kernel K3 - K3 against its plain version on the card, meta and moves
              exactly, on the case sets of tests/band_cases.py: both modes at
              max_insert 7, 20 and 100, homologous, unrelated and N-run
              problems up to 2,000 bases, sides of one base, both
              directions, a band that runs off `b`, out-of-band tracebacks
              in both modes and a band centre that leaves the state arrays;
              then BandExtBatch on the card against numpy band_ext on a
              subset, errors included.
6. fixtures - scoreChain, chainNet -rescore and chainCleaner through the
              port's CLI on the card, byte-compared with tests/golden; each
              must launch K1.  Then the same in pair mode (GAT_RESCORE=pair
              GAT_COMBINE=device): chainNet -rescore and chainCleaner must
              launch K2.
7. chr1     - the bench workload (utils/bench_workload.py, 256 Mb per genome,
              384 chains, ~367 Mb aligned) through the port's scoreChain,
              byte-compared with a host-native run of the same file; cold and
              warm seconds, Mb aligned per second, K1 launches, and K1's time
              against the plain version's at the main path's shapes.
8. resident - the same chains through TorchPairChainScorer (bench.py's
              resident protocol): every chain's (global, local) equal to the
              host-native scores; pack, upload, single-pass and sustained
              per-pass times, bytes a pass moves against the card's published
              HBM bandwidth, K2's time against the plain version's at these
              shapes, peak device memory.
9. cleaner  - chainNet -rescore on the chainCleaner bench workload
              (build_cleaner_workload, as bench.py builds it) through the
              port in window mode and in pair mode with the device combine,
              each byte-compared with a host-native run; wall seconds of all.
10. gap fixtures - RepeatFiller --refQuirks through the port's CLI on the
              card, byte-identical to tests/golden; RepeatFiller in clean
              mode and patchChain (6 arguments, with and without -unmask),
              byte-compared with the reference CLI run in a subprocess with
              GAT_BAND=host; each port run must launch K3.
11. repeatfiller - build_repeatfiller_workload(n_gaps=600), bench.py's
              depth, through the port's RepeatFiller (must launch K3) and
              the host-native reference CLI, byte-compared, wall seconds of
              both; then the workload's extension problems (align_prepare)
              through K3 and through the plain version in K3's sub-batches:
              equal, CUDA-event ms of each, problem and column counts, peak
              device memory.
12. filterChains - FilterChainsNetFilterNets through the port's CLI on the
              fixtures, byte-identical to tests/golden; must launch K1.
13. sharded - the chr1 chains through ShardedChainScorer on [cuda:0] * k,
              k = 1, 2, 4, and on make_mesh(): every (global, local,
              aliBases) equal to the host-native scores of phase 8, one K2
              launch per non-empty shard, seconds per k;
              ShardedBlockScorer at k = 4 on one (t, q, strand) group equal
              to the single-device K1 sums.
14. distributed - clean_chains_distributed on the cleaner workload as two
              rank subprocesses on torch.distributed, gloo with both ranks
              on cuda:0 (and nccl with one card per rank where there are
              two cards): merged chain and bed byte-identical to a
              single-process host-native chainCleaner run; wall seconds.
15. profile - the port's scoreChain on chr1 (warm) with -profile=dir, twice:
              each torch.profiler trace must name K1's kernel; summed CUDA
              kernel time, the traced window and their ratio (device-busy
              share).
16. dryrun  - dryrun_multidevice([cuda:0] * 4): the sharded scorers, the
              sharded cleaner, chainNet -rescore and RepeatFiller on the
              fixtures, and the band DP split across devices, all exact.

Phases run in this order.  The line before the last is a JSON object
{"kernels": [...]} whose launches sum every path's counts (each set to 0
just before the path and read just after); the last line is {"ok": true,
"device": {"platform": "gpu", ...}}.  Imports nothing of jax.
"""

from __future__ import annotations

import contextlib
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
K2 = "pair_combine"
K3 = "band_ext"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 bandwidth
PAIR_ENV = {"GAT_RESCORE": "pair", "GAT_COMBINE": "device"}


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


def k2_against_plain(s, bias, flags, start_idx, end_idx) -> int:
    """K2 == its plain version and K2 + finish == the staged int64 combine,
    on one set of card tensors; returns the max abs difference."""
    import torch

    from genomealignmenttools_tpu_torch.ops import pair_combine as pc
    from genomealignmenttools_tpu_torch.ops.pair_rescore import \
        pair_chain_scores_plain
    c, w = pc.pair_combine_scan(s, bias, flags)
    c_plain, w_plain = pc.pair_combine_scan_plain(s, bias, flags)
    fin = pc.pair_combine_finish(c, w, end_idx).to(torch.int64)
    staged = pair_chain_scores_plain(s, bias, flags, start_idx, end_idx)
    torch.cuda.synchronize()
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in ((c, c_plain), (w, w_plain), (fin, staged)))


def phase_kernel_k2(dev) -> int:
    """Exact K2 == plain (and == staged) on the card; returns the max abs
    difference."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from combine_cases import combine_case, edge_chains, random_chains
    from genomealignmenttools_tpu_torch.ops.pair_combine import TILE

    rng = np.random.default_rng(20261017)
    cases = [("edge cases", edge_chains(TILE), TILE),
             ("7 chains, unpadded", random_chains(rng, 7), 1)]
    cases += [(f"{n} chains", random_chains(rng, n), TILE)
              for n in (7, 800, 200_000)]
    worst = 0
    for label, (nb, nc), pad_to in cases:
        s, bias, flags, start_idx, end_idx, m = combine_case(rng, nb, nc,
                                                             pad_to)
        lengths = end_idx - start_idx + 1
        if label == "edge cases":
            check(lengths.max() > 3 * TILE and (lengths == 1).any()
                  and (end_idx % TILE == TILE - 1).any() and s.shape[0] > m,
                  "the edge-case workload lost one of its cases")
        card = [torch.from_numpy(a).to(dev)
                for a in (s, bias, flags, start_idx, end_idx)]
        diff = k2_against_plain(*card)
        worst = max(worst, diff)
        check(diff == 0, f"K2 != plain or staged on {label} (max {diff})")
        print(f"[kernel K2] {label}: {len(end_idx)} chains, {m} chunks + "
              f"{s.shape[0] - m} pad, {-(-s.shape[0] // TILE)} tiles of "
              f"{TILE}; longest chain {int(lengths.max())} chunks, "
              f"{int((lengths == 1).sum())} single-chunk chains, "
              f"{int((end_idx % TILE == TILE - 1).sum())} ending on a "
              f"tile's last chunk: kernel == plain and finish == staged "
              f"exactly")
        del card
    return worst


@contextlib.contextmanager
def environ(env: dict):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(args: list[str], env: dict | None = None) -> dict:
    """One port CLI run on the card, with `env` set for it; returns its
    launch counts (set to 0 just before, read just after)."""
    import torch

    from genomealignmenttools_tpu_torch.cli.main import main
    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    with environ(env or {}):
        perf_reset()
        rc = main(args + ["-device=cuda"])
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    check(rc == 0, f"CLI {args[0]} exited {rc}")
    return counts


def phase_fixtures(tmp: str) -> None:
    """The three tools on the fixtures in window mode (K1), then in pair mode
    with the device combine (K2; scoreChain takes score_table and the native
    combine there, as in the reference, and launches neither kernel)."""
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
    for mode, env in (("window", None), ("pair", PAIR_ENV)):
        for label, args, pairs in runs:
            t0 = time.monotonic()
            counts = run_cli(args, env)
            secs = time.monotonic() - t0
            if env is None:
                check(counts[KERNEL] > 0, f"{label} never launched {KERNEL}")
            elif label != "scoreChain":
                check(counts[K2] > 0, f"{label} (pair) never launched {K2}")
            for got, want in pairs:
                check(same_bytes(got, want),
                      f"{label} ({mode}): {got} != {want}")
            print(f"[fixtures] {label} ({mode} mode): byte-identical to "
                  f"{', '.join(os.path.basename(w) for _, w in pairs)}; "
                  + ", ".join(f"{k} launches {v}" for k, v in counts.items())
                  + f"; {secs:.3f} s")


class HostNativeScorer:
    """The reference's all-host scoring (DeviceChainScorer in `hostnative`
    mode, ops/rescore.py:319-324, 521-534) without the class that imports
    jax: score_table is gat_subset_scores over full-cover jobs, and a
    host-native `_dev` sends chainNet -rescore to its fused native sub-chain
    scoring (chain_net.py:1006-1043).  score_chains and global_score, the
    engine's other routes, score on the host with engines.scoring."""

    def __init__(self, scheme, gap_calc, t_genome, q_genome):
        import types

        from genomealignmenttools_tpu.engines.scoring import ChainScorer
        self.scheme, self.gap_calc = scheme, gap_calc
        self.t_genome, self.q_genome = t_genome, q_genome
        self._dev = types.SimpleNamespace(host_native=True)
        self._host = ChainScorer(scheme, gap_calc, t_genome, q_genome)

    def global_score(self, chain) -> float:
        return self._host.global_score(chain)

    def score_chains(self, chains: list) -> list:
        return [self._host.global_and_local(c) for c in chains]

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


def phase_chr1(tmp: str, dev, t_size: int = 256_000_000,
               n_chains: int = 384) -> tuple[dict, dict]:
    """Returns K1's kernels-line entry and the workload's paths."""
    import torch

    from genomealignmenttools_tpu.engines.score_chain import score_chain_file
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu.utils.bench_workload import build_workload
    from genomealignmenttools_tpu.utils.profiling import (phase_acc_start,
                                                         phase_acc_stop)
    from genomealignmenttools_tpu_torch.ops import window_rescore as wr

    t0 = time.monotonic()
    meta = build_workload(os.path.join(tmp, "chr1"), t_size=t_size,
                          n_chains=n_chains)
    mb = meta["aligned_bases"] / 1e6
    print(f"[chr1] workload: {t_size / 1e6:g} Mb per genome, {n_chains} "
          f"chains, {mb:.3f} Mb aligned; built in "
          f"{time.monotonic() - t0:.3f} s (set-up)")
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
    return entry, meta


def timed(fn):
    t0 = time.monotonic()
    out = fn()
    return time.monotonic() - t0, out


def phase_resident(meta: dict, dev) -> dict:
    """The chr1 chains through TorchPairChainScorer, following bench.py's
    resident protocol (bench.py:500-522); returns K2's times and error."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu.device.genome import open_genome
    from genomealignmenttools_tpu.formats.chain import read_chains
    from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu.native.chain_io import parse_chain_table
    from genomealignmenttools_tpu.utils.profiling import (phase_acc_start,
                                                         phase_acc_stop)
    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    from genomealignmenttools_tpu_torch.ops import pair_combine as pc
    from genomealignmenttools_tpu_torch.ops.pair_rescore import \
        TorchPairChainScorer
    from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer

    scheme, gap_calc = score_scheme_default(), gap_calc_from_file("loose")
    t_gen, q_gen = open_genome(meta["t2bit"]), open_genome(meta["q2bit"])
    chains = read_chains(meta["chain"])
    scorer = TorchChainScorer(scheme, gap_calc, t_gen, q_gen, device=dev,
                              mode="pair")
    pcs = TorchPairChainScorer(scorer._dev, gap_calc)
    jobs, order = scorer._grouped(chains)
    nblocks = [chains[i].n_blocks for i in order]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase_acc_start()
    pack = scorer._dev._pack(jobs)
    torch.cuda.synchronize()
    phases = phase_acc_stop()
    meta_s, pmeta = timed(lambda: pcs._meta(jobs, nblocks))
    tiles_mb = pack.tiles.numel() / 1e6
    print(f"[resident] {len(chains)} chains, {pack.n_blocks} blocks, "
          f"{pack.m} chunks ({pack.tiles.shape[0]} rows of "
          f"{pack.tiles.shape[1]} with pads): host pack "
          f"{phases['rescore: pair pack']:.4f} s, upload of {tiles_mb:.3f} MB "
          f"int8 tiles {phases['rescore: pair tiles to device']:.4f} s "
          f"({tiles_mb / phases['rescore: pair tiles to device'] / 1e3:.3f} "
          f"GB/s), scan metadata (host, then "
          f"{(pmeta.bias.numel() * 8 + pmeta.end_idx.numel() * 8) / 1e6:.3f}"
          f" MB up) {meta_s:.4f} s (set-up, once per chain set)")

    perf_reset()
    out0 = pcs.score_chained(jobs, nblocks, 1)   # first pass
    singles = []
    for _ in range(3):
        dt, out = timed(lambda: pcs.score_chained(jobs, nblocks, 1))
        check(np.array_equal(out, out0), "resident pass is not repeatable")
        singles.append(dt)
    t41, out41 = timed(lambda: pcs.score_chained(jobs, nblocks, 41))
    check(np.array_equal(out41, out0), "chained passes changed the scores")
    per_pass = (t41 - min(singles)) / 40
    launches = LAUNCHES[K2]
    check(launches == 45, f"resident passes launched {K2} {launches} times")
    with open(meta["chain"], "rb") as f:
        table = parse_chain_table(f.read())
    host_rows = HostNativeScorer(scheme, gap_calc, t_gen, q_gen).score_table(
        table)
    host = host_rows[np.asarray(order)]
    check(np.array_equal(out0.astype(np.float64), host[:, :2]),
          "resident (global, local) differ from the host-native scores")
    check(pcs.score(jobs, nblocks) == [(g, loc, int(a)) for g, loc, a in
                                       host.tolist()],
          "TorchPairChainScorer.score differs from the host-native scores")
    hbm = pcs.resident_hbm_bytes(jobs, nblocks)
    mb = meta["aligned_bases"] / 1e6
    print(f"[resident] every chain's (global, local, aliBases) equals the "
          f"host-native scores; {K2} launches {launches} in 45 passes")
    print(f"[resident] single pass (chunk sums + K2 + finish + fetch) "
          f"{min(singles) * 1e3:.3f} ms (of {[round(x * 1e3, 3) for x in singles]}"
          f"); sustained {per_pass * 1e3:.4f} ms per pass = (T(41) "
          f"{t41 * 1e3:.3f} ms - T(1)) / 40, {mb / per_pass / 1e3:.3f} Gb "
          f"aligned/s")
    print(f"[resident] resident_hbm_bytes {hbm} ({hbm / 1e6:.3f} MB) per "
          f"pass: {hbm / per_pass / 1e9:.3f} GB/s sustained, "
          f"{100 * hbm / per_pass / HBM_BYTES_PER_S:.2f}% of the published "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    s = scorer._dev.chunk_sums(jobs)
    start_idx = torch.from_numpy(pmeta.start_idx).to(dev)
    worst = k2_against_plain(s, pmeta.bias, pmeta.flags, start_idx,
                             pmeta.end_idx)
    check(worst == 0, f"K2 != plain at resident shapes (max {worst})")
    ms = {}
    # plain, kernel, kernel, plain: compare within one call, in turns
    for label, fn, reps in (
            ("plain", pc.pair_combine_scan_plain, 3),
            ("kernel", pc._launch_kernel, 50),
            ("kernel", pc._launch_kernel, 50),
            ("plain", pc.pair_combine_scan_plain, 3)):
        ms.setdefault(label, []).append(
            cuda_ms(lambda fn=fn: fn(s, pmeta.bias, pmeta.flags), reps))
    row_ms = cuda_ms(lambda: pack.tiles.sum(dim=1, dtype=torch.int32), 50)
    print(f"[resident] K2 at these shapes ({s.numel()} chunks, "
          f"{-(-s.numel() // pc.TILE)} tiles): kernel {ms['kernel']} ms, "
          f"plain {ms['plain']} ms; kernel == plain exactly; the int8 row "
          f"sums (torch) {row_ms:.4f} ms")
    print(f"[resident] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return {"ms": min(ms["kernel"]), "plain_ms": min(ms["plain"]),
            "max_abs_err": worst,
            "host": [(g, loc, int(a)) for g, loc, a in host_rows.tolist()]}


def phase_cleaner(tmp: str, n_scenarios: int = 2000,
                  n_bulk: int = 30000) -> tuple[int, dict]:
    """chainNet -rescore on the chainCleaner bench workload (bench.py:
    555-558) through the port in window and pair mode, byte-compared with a
    host-native run; returns K2's launches in the pair run and the
    workload."""
    from genomealignmenttools_tpu.engines.chain_net import chain_net
    from genomealignmenttools_tpu.utils.bench_workload import \
        build_cleaner_workload

    t0 = time.monotonic()
    w = build_cleaner_workload(os.path.join(tmp, "cleaner"),
                               n_scenarios=n_scenarios, n_bulk=n_bulk)
    print(f"[cleaner] workload: {n_scenarios} planted scenarios + {n_bulk} "
          f"bulk chains; built in {time.monotonic() - t0:.3f} s (set-up)")
    out = lambda tag, side: os.path.join(tmp, f"cl.{tag}.{side}.net")  # noqa

    def host_native(tag: str) -> float:
        t0 = time.monotonic()
        with open(out(tag, "t"), "w") as t_net, \
                open(out(tag, "q"), "w") as q_net:
            chain_net(w["chain"], w["t_sizes"], w["q_sizes"], t_net, q_net,
                      rescore=True, t_2bit=w["t2bit"], q_2bit=w["q2bit"],
                      linear_gap="loose", scorer_factory=HostNativeScorer)
        return time.monotonic() - t0

    secs = {"host-native (cold: decodes both genomes)":
            host_native("host")}
    counts = {}
    for tag, env in (("window", None), ("pair", PAIR_ENV)):
        t0 = time.monotonic()
        counts[tag] = run_cli(
            ["chainNet", w["chain"], w["t_sizes"], w["q_sizes"],
             out(tag, "t"), out(tag, "q"), "-rescore",
             "-tNibDir=" + w["t2bit"], "-qNibDir=" + w["q2bit"],
             "-linearGap=loose"], env)
        secs[f"port {tag} mode"] = time.monotonic() - t0
        for side in ("t", "q"):
            check(same_bytes(out(tag, side), out("host", side)),
                  f"cleaner-scale chainNet -rescore ({tag}): {side}.net "
                  f"differs from the host-native run")
    secs["host-native (warm)"] = host_native("host2")
    check(counts["window"][KERNEL] > 0, "window run never launched K1")
    check(counts["pair"][K2] > 0, f"pair run never launched {K2}")
    print(f"[cleaner] chainNet -rescore: window and pair mode byte-identical "
          f"to the host-native run; launches window {counts['window']}, "
          f"pair {counts['pair']}")
    print("[cleaner] wall seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return counts["pair"][K2], w

def k3_against_plain(args, mat, global_mode, gap_open, gap_extend,
                     max_insert) -> tuple[int, "object"]:
    """K3 == band_ext_plain on one set of card inputs; returns the max abs
    difference over meta and moves, and K3's meta."""
    import torch

    from genomealignmenttools_tpu_torch.ops import band_batch as bb
    got = bb.band_ext_cuda(*args, mat, global_mode, gap_open, gap_extend,
                           max_insert)
    want = bb.band_ext_plain(*args, mat, global_mode, gap_open, gap_extend,
                             max_insert)
    torch.cuda.synchronize()
    diff = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))
    return diff, got[0]


def phase_kernel_k3(dev) -> int:
    """Exact K3 == plain on the card on every case set, and BandExtBatch on
    the card == numpy band_ext on a subset; returns the max abs
    difference."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from band_cases import kernel_cases, outcome, raw_inputs
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu.ops.band_ext import band_ext
    from genomealignmenttools_tpu_torch.ops import band_batch as bb

    cm = score_scheme_default().char_matrix()
    worst, errs, n_oracle = 0, set(), 0
    for label, g, gap_open, gap_extend, mi, probs in kernel_cases():
        batch = bb.BandExtBatch(g, cm, gap_open, gap_extend, mi, device=dev)
        args = raw_inputs(probs, dev)
        diff, meta = k3_against_plain(args, batch.mat, g, gap_open,
                                      gap_extend, mi)
        worst = max(worst, diff)
        check(diff == 0, f"K3 != plain on {label} (max {diff})")
        err = meta[:, 5].cpu()
        errs |= {(g, int(e)) for e in err.unique()}
        sub = probs[:8]
        want = [outcome(lambda p=p: band_ext(g, cm, gap_open, gap_extend,
                                             mi, *p)) for p in sub]
        fine = [p for p, w in zip(sub, want) if isinstance(w, tuple)]
        check(batch.run(fine) == [w for w in want if isinstance(w, tuple)],
              f"BandExtBatch on the card != band_ext on {label}")
        for p, w in zip(sub, want):
            if not isinstance(w, tuple):
                check(outcome(lambda p=p: batch.run([p])) is w,
                      f"BandExtBatch on the card does not raise {w} on "
                      f"{label}")
        n_oracle += len(sub)
        print(f"[kernel K3] {label}: {int(args[1].numel()) - 1} problems, "
              f"{int(args[0].numel())} + {int(args[2].numel())} bases, "
              f"longest a {max(len(p[0]) for p in probs)}; "
              f"{int((meta[:, 0] != 0).sum())} aligned, err codes "
              f"{sorted(int(e) for e in err.unique())}: kernel == plain "
              f"exactly")
    check({(False, 1), (True, 1), (True, 2)} <= errs,
          f"the K3 cases lost an error case: {sorted(errs)}")
    print(f"[kernel K3] BandExtBatch on the card == numpy band_ext on "
          f"{n_oracle} problems (tuples, AssertionError and IndexError)")
    return worst


def reference_cli(args: list[str]) -> float:
    """The reference CLI in a subprocess with its host-native paths
    (GAT_BAND=host; JAX_PLATFORMS=cpu, so that jax, where installed, leaves
    the card alone); returns its wall seconds."""
    env = dict(os.environ, GAT_BAND="host", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "genomealignmenttools_tpu.cli.main", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    secs = time.monotonic() - t0
    check(res.returncode == 0, f"reference CLI {args[0]} exited "
          f"{res.returncode}: {res.stderr[-2000:]}")
    return secs


def phase_gap_fixtures(tmp: str) -> None:
    """RepeatFiller and patchChain through the port's CLI on the card."""
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    o = lambda n: os.path.join(tmp, n)  # noqa: E731
    rf = ["RepeatFiller", "-c", f("repeatfiller_input.chain"),
          "-T2", f("target.2bit"), "-Q2", f("query.2bit"), "-o"]
    pc = ["patchChain", f("repeatfiller_input.chain"), f("target.2bit"),
          f("query.2bit"), f("target.chrom.sizes"), f("query.chrom.sizes")]
    runs = [("RepeatFiller --refQuirks", rf, ["--refQuirks"], "rfq.chain"),
            ("RepeatFiller", rf, [], "rf.chain"),
            ("patchChain", pc, [], "pc.psl"),
            ("patchChain -unmask", pc, ["-unmask"], "pcu.psl")]
    for label, argv, extra, name in runs:
        t0 = time.monotonic()
        counts = run_cli(argv + [o(name)] + extra)
        secs = time.monotonic() - t0
        check(counts[K3] > 0, f"{label} never launched {K3}")
        if label == "RepeatFiller --refQuirks":
            want = os.path.join(GOLD, "repeatfiller_reference_output.chain")
        else:
            want = o("ref." + name)
            reference_cli(argv + [want] + extra)
        check(same_bytes(o(name), want), f"{label}: {o(name)} != {want}")
        print(f"[gap fixtures] {label}: byte-identical to "
              f"{os.path.basename(want)}"
              + ("" if want.startswith(GOLD) else " (reference CLI, "
                 "GAT_BAND=host)")
              + f"; {K3} launches {counts[K3]}; {secs:.3f} s")


def phase_repeatfiller(tmp: str, dev, n_gaps: int = 600) -> dict:
    """RepeatFiller at bench.py's depth; returns K3's kernels-line numbers."""
    import torch

    from genomealignmenttools_tpu.device.genome import open_genome
    from genomealignmenttools_tpu.engines.repeat_filler import (
        _gap_job_regions, harvest_gap_jobs)
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu.utils.bench_workload import \
        build_repeatfiller_workload
    from genomealignmenttools_tpu.utils.profiling import (phase_acc_start,
                                                         phase_acc_stop)
    from genomealignmenttools_tpu_torch.ops import band_batch as bb
    from genomealignmenttools_tpu_torch.ops.seed_extend import \
        TorchGapAligner

    t0 = time.monotonic()
    w = build_repeatfiller_workload(os.path.join(tmp, "rf"), n_gaps=n_gaps)
    print(f"[repeatfiller] workload: {n_gaps} gaps; built in "
          f"{time.monotonic() - t0:.3f} s (set-up)")
    args = ["RepeatFiller", "-c", w["chain"], "-T2", w["t2bit"],
            "-Q2", w["q2bit"], "-o"]
    port_out, host_out = (os.path.join(tmp, "rf.port.chain"),
                          os.path.join(tmp, "rf.host.chain"))
    torch.cuda.reset_peak_memory_stats()
    phase_acc_start()
    t0 = time.monotonic()
    counts = run_cli(args + [port_out])   # counts reset just before
    port_s = time.monotonic() - t0
    phases = phase_acc_stop()
    check(counts[K3] > 0, f"{n_gaps}-gap RepeatFiller never launched {K3}")
    peak_cli = torch.cuda.max_memory_allocated()
    host_s = reference_cli(args + [host_out])
    check(same_bytes(port_out, host_out),
          f"{n_gaps}-gap RepeatFiller differs from the host-native run")
    start_s = reference_cli(["RepeatFiller", "-h"])
    band_s = sum(v for k, v in phases.items() if k.startswith("band: "))
    print(f"[repeatfiller] port RepeatFiller {port_s:.3f} s ({K3} launches "
          f"{counts[K3]}, peak device memory {peak_cli / 2**30:.3f} GiB); "
          f"band stage {band_s:.4f} s: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items())
          + f"; the rest (seeds, HSP scan, chaining, splice) "
          f"{port_s - band_s:.3f} s")
    print(f"[repeatfiller] host-native reference CLI (subprocess, "
          f"GAT_BAND=host) {host_s:.3f} s, of which interpreter start-up "
          f"and imports (RepeatFiller -h) {start_s:.3f} s; byte-identical "
          f"to the port's output")

    # the workload's extension problems, as _run_gap_jobs batches them
    scheme = score_scheme_default()
    aligner = TorchGapAligner(
        scheme.lut, seed_len=6, hsp_threshold=1500, gapped_threshold=2000,
        gap_open=scheme.gap_open, gap_extend=scheme.gap_extend,
        char_matrix=scheme.char_matrix(), device=dev)
    with open(w["chain"]) as fh:
        lines = [ln + "\n" for ln in fh.read().split("\n")]
    jobs = harvest_gap_jobs(lines, 0, 0, 0, 10, 10, 100000, 100000)
    t_gen, q_gen = open_genome(w["t2bit"]), open_genome(w["q2bit"])
    t0 = time.monotonic()
    probs = []
    for job in jobs:
        (t_codes, q_codes, _ts, _qs, t_lo, t_hi, q_lo,
         q_hi) = _gap_job_regions(job, t_gen, q_gen)
        probs.extend(aligner.align_prepare(t_codes, q_codes, t_lo, t_hi,
                                           q_lo, q_hi)[2])
    prep_s = time.monotonic() - t0
    batch = aligner._band_batch()
    _, todo = bb.orient(probs, batch.a_max)
    band = 2 * batch.max_insert + 1
    ranges = bb.sub_batches([len(t[1]) for t in todo], band, False,
                            bb.PARENT_BUDGET)
    a_cols = sum(len(t[1]) for t in todo)
    b_bases = sum(len(t[2]) for t in todo)
    print(f"[repeatfiller] {len(jobs)} gaps -> {len(probs)} extension "
          f"problems ({len(todo)} with both sides), {a_cols} DP columns "
          f"({a_cols * band} band cells), {b_bases} b bases; "
          f"align_prepare (host) {prep_s:.3f} s; {len(ranges)} K3 "
          f"sub-batches under {bb.PARENT_BUDGET} parent bytes")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    worst, ms = 0, {"kernel": 0.0, "plain": 0.0}
    call = lambda fn, a: fn(*a, batch.mat, False, batch.gap_open,  # noqa
                            batch.gap_extend, batch.max_insert)
    for lo, hi in ranges:
        a = [torch.from_numpy(x).to(dev) for x in bb.pack(todo[lo:hi])]
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        plain = call(bb.band_ext_plain, a)
        end.record()
        torch.cuda.synchronize()
        ms["plain"] += start.elapsed_time(end)
        ms["kernel"] += cuda_ms(lambda a=a: call(bb._launch_kernel, a), 3)
        got = call(bb._launch_kernel, a)
        torch.cuda.synchronize()
        worst = max(worst, *(int((g.to(torch.int64) - p.to(torch.int64))
                                 .abs().max()) for g, p in zip(got, plain)))
        del plain, got
    check(worst == 0, f"K3 != plain at the {n_gaps}-gap shapes (max {worst})")
    print(f"[repeatfiller] K3 at the {n_gaps}-gap shapes: kernel "
          f"{ms['kernel']:.3f} ms, plain {ms['plain']:.3f} ms (summed over "
          f"{len(ranges)} sub-batches); kernel == plain exactly; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return {"launches": counts[K3], "max_abs_err": worst,
            "ms": ms["kernel"], "plain_ms": ms["plain"]}


def phase_sharded(meta: dict, host: list, dev) -> dict:
    """The chr1 chains through ShardedChainScorer on ["cuda:0"] * k, k = 1,
    2, 4, and on make_mesh() (every visible card), each equal to the
    host-native scores; ShardedBlockScorer on one (t, q, strand) group at
    k = 4 against the single-device K1 sums.  Returns the launches."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu.device.genome import open_genome
    from genomealignmenttools_tpu.formats.chain import read_chains
    from genomealignmenttools_tpu.formats.gapcalc import gap_calc_from_file
    from genomealignmenttools_tpu.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    from genomealignmenttools_tpu_torch.parallel.mesh import (
        ShardedBlockScorer, ShardedChainScorer, make_mesh)

    scheme, gap_calc = score_scheme_default(), gap_calc_from_file("loose")
    t_gen, q_gen = open_genome(meta["t2bit"]), open_genome(meta["q2bit"])
    chains = read_chains(meta["chain"])
    total = {KERNEL: 0, K2: 0}
    meshes = [(f"[cuda:0] * {k}", [dev] * k) for k in (1, 2, 4)]
    meshes.append((f"make_mesh() ({torch.cuda.device_count()} cards)",
                   make_mesh()))
    for label, mesh in meshes:
        scorer = ShardedChainScorer(scheme, gap_calc, t_gen, q_gen, mesh)
        cuts = scorer.cuts(chains)
        secs = []
        for _ in range(2):      # first: pack, upload, metadata; then warm
            perf_reset()
            t0 = time.monotonic()
            got = scorer.score_chains(chains)
            secs.append(time.monotonic() - t0)
            launches = LAUNCHES[K2]
            total[K2] += launches
            check(got == host, f"ShardedChainScorer on {label} differs from "
                               "the host-native scores")
            check(launches == sum(b > a for a, b in zip(cuts, cuts[1:])),
                  f"ShardedChainScorer on {label}: {launches} {K2} launches "
                  f"for cuts {cuts}")
        print(f"[sharded] ShardedChainScorer on {label}: {len(chains)} chains "
              f"cut at {cuts}; every (global, local, aliBases) equals the "
              f"host-native scores; {K2} launches {launches} per call; "
              f"first call (pack, upload, metadata, pass) {secs[0]:.3f} s, "
              f"warm {secs[1] * 1e3:.3f} ms")
        del scorer

    key = (chains[0].t_name, chains[0].q_name, chains[0].q_strand)
    blocks = np.concatenate([c.blocks for c in chains
                             if (c.t_name, c.q_name, c.q_strand) == key])
    args = (t_gen.codes(key[0], "+"), q_gen.codes(key[1], key[2]), blocks)
    lut = np.asarray(scheme.lut)
    want = ShardedBlockScorer(lut, [dev]).block_scores(*args)
    perf_reset()
    t0 = time.monotonic()
    got = ShardedBlockScorer(lut, [dev] * 4).block_scores(*args)
    secs = time.monotonic() - t0
    total[KERNEL] += LAUNCHES[KERNEL]
    check(LAUNCHES[KERNEL] == 4, f"ShardedBlockScorer launched {KERNEL} "
                                 f"{LAUNCHES[KERNEL]} times on 4 shards")
    check(np.array_equal(got, want), "ShardedBlockScorer at k = 4 != the "
                                     "single-device K1 sums")
    print(f"[sharded] ShardedBlockScorer on [cuda:0] * 4, group {key}: "
          f"{blocks.shape[0]} blocks equal to the single-device K1 sums; "
          f"{KERNEL} launches 4; {secs:.3f} s (genome upload included)")
    return total


_RANK = r"""
import json, sys, time
init, rank, backend, device, w_json, out = sys.argv[1:7]
w = json.loads(w_json)
from genomealignmenttools_tpu.utils.verbose import set_verbosity
from genomealignmenttools_tpu_torch.device import LAUNCHES
from genomealignmenttools_tpu_torch.engines.chain_cleaner import \
    clean_chains_distributed
from genomealignmenttools_tpu_torch.parallel.distributed import \
    init_distributed
import torch, torch.distributed as dist
set_verbosity(0)
init_distributed(backend, init_method=init, world_size=2, rank=int(rank))
t0 = time.monotonic()
clean_chains_distributed(w["chain"], w["t2bit"], w["q2bit"], out + ".chain",
                         out + ".bed", out + ".work",
                         max_gather_bytes=int(w["max_bytes"]), device=device,
                         t_sizes=w["t_sizes"], q_sizes=w["q_sizes"],
                         linear_gap="loose")
if device.startswith("cuda"):
    torch.cuda.synchronize()
secs = time.monotonic() - t0
dist.destroy_process_group()
print("RANK " + json.dumps({"rank": int(rank), "secs": secs,
                            "launches": dict(LAUNCHES)}), flush=True)
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_ranks(backend: str, devices: list[str], w: dict, out: str) -> dict:
    """clean_chains_distributed in two rank subprocesses; returns the wall
    seconds, each rank's seconds and the summed launches.  Both ranks are
    killed if either fails or the limit passes."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    init = f"tcp://127.0.0.1:{free_port()}"
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, init, str(r), backend, devices[r],
         json.dumps(w), out], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.monotonic() - t0
    ranks = []
    for r, (p, (stdout, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{backend} rank {r} exited {p.returncode}"
                                 f": {err[-2000:]}")
        line = [ln for ln in stdout.splitlines() if ln.startswith("RANK ")]
        ranks.append(json.loads(line[-1][5:]))
    launches = {k: sum(rk["launches"][k] for rk in ranks)
                for k in ranks[0]["launches"]}
    return {"wall": wall, "ranks": [rk["secs"] for rk in ranks],
            "launches": launches}


def phase_distributed(tmp: str, w: dict) -> dict:
    """chainCleaner on the cleaner workload as two torch.distributed ranks
    (clean_chains_distributed), gloo with both ranks on cuda:0, and nccl
    with one card per rank where there are two cards; each merged output
    byte-identical to a single-process host-native chainCleaner run (the
    reference CLI in a subprocess: its native break loop imports the
    reference's jax-backed pair_rescore).  Returns the summed launches of
    the rank processes."""
    import torch

    o = lambda n: os.path.join(tmp, n)  # noqa: E731
    host_s = reference_cli([
        "chainCleaner", w["chain"], w["t2bit"], w["q2bit"], o("dc.host.chain"),
        o("dc.host.bed"), "-tSizes=" + w["t_sizes"],
        "-qSizes=" + w["q_sizes"], "-linearGap=loose", "-verbose=0"])
    w = dict(w, max_bytes=2 * os.path.getsize(w["chain"]) + (1 << 20))
    runs = [("gloo", ["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", ["cuda:0", "cuda:1"]))
    total: dict = {}
    for backend, devices in runs:
        res = two_ranks(backend, devices, w, o(f"dc.{backend}"))
        for ext in ("chain", "bed"):
            check(same_bytes(o(f"dc.{backend}.{ext}"), o(f"dc.host.{ext}")),
                  f"two-rank {backend} chainCleaner .{ext} differs from the "
                  f"single-process host-native run")
        check(res["launches"][KERNEL] > 0, f"the {backend} ranks never "
                                           f"launched {KERNEL}")
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
        print(f"[distributed] clean_chains_distributed, 2 ranks, {backend} "
              f"on {devices}: chain and bed byte-identical to the "
              f"single-process host-native run; wall {res['wall']:.3f} s "
              f"(rank start-up included), ranks {[round(x, 3) for x in res['ranks']]}"
              f" s inside clean_chains_distributed; launches "
              f"{res['launches']}")
    if torch.cuda.device_count() < 2:
        print(f"[distributed] NCCL not exercised on this machine: "
              f"{torch.cuda.device_count()} card")
    print(f"[distributed] single-process host-native chainCleaner "
          f"(reference CLI in a subprocess, start-up included) {host_s:.3f} s")
    return total


def short_name(kernel: str) -> str:
    """A kernel's name without return type, namespace marker, template and
    argument lists."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


def phase_profile(tmp: str, meta: dict) -> int:
    """The port's scoreChain on chr1 (warm) under -profile=dir, twice (the
    first run also starts the profiler's device tracing): each trace must
    name K1; prints, for the second, the summed kernel time, the traced
    window and their ratio, the device-busy share.  Returns K1's
    launches."""
    from genomealignmenttools_tpu_torch.utils.profiling import \
        set_profile_dir

    args = ["scoreChain", meta["chain"], meta["t2bit"], meta["q2bit"],
            os.path.join(tmp, "chr1.prof.chain"), "-linearGap=loose"]
    secs, launches = [], 0
    for i in range(2):
        prof = os.path.join(tmp, f"profile{i}")
        t0 = time.monotonic()
        try:
            counts = run_cli(args + ["-profile=" + prof])
        finally:
            set_profile_dir(None)
        secs.append(time.monotonic() - t0)
        launches += counts[KERNEL]
        check(counts[KERNEL] > 0, f"profiled scoreChain never launched "
                                  f"{KERNEL}")
        check(same_bytes(args[4], os.path.join(tmp, "chr1.dev.chain")),
              "profiled chr1 scoreChain differs from the unprofiled run")
        (name,) = os.listdir(prof)
        with open(os.path.join(prof, name)) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(any(f"{KERNEL}_kernel" in e["name"] for e in kernels),
              f"the trace names no {KERNEL}_kernel: "
              f"{sorted({e['name'] for e in kernels})[:10]}")
    busy = sum(e.get("dur", 0) for e in kernels)
    window = (max(e["ts"] + e.get("dur", 0) for e in events)
              - min(e["ts"] for e in events))
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    print(f"[profile] port scoreChain on chr1 (warm) with -profile, twice: "
          f"{secs[0]:.3f} s (profiler start-up included), {secs[1]:.3f} s; "
          f"{KERNEL} launches {launches}, outputs byte-identical; second "
          f"trace {name} ({os.path.getsize(os.path.join(prof, name))} "
          f"bytes, {len(events)} events, {len(kernels)} kernels)")
    print(f"[profile] summed CUDA kernel time {busy / 1e3:.4f} ms in a traced "
          f"window of {window / 1e3:.3f} ms: device-busy share "
          f"{100 * busy / window:.4f}%; by kernel (ms) "
          + ", ".join(f"{short_name(k)} {v / 1e3:.4f}" for k, v in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))
    return launches


def phase_filter_chains(tmp: str) -> int:
    """FilterChainsNetFilterNets through the port's CLI on the fixtures,
    byte-identical to tests/golden; must launch K1.  Returns the launches."""
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    o = lambda n: os.path.join(tmp, n)  # noqa: E731
    t0 = time.monotonic()
    counts = run_cli(["FilterChainsNetFilterNets",
                      f("synthetic.scored.sorted.chain"),
                      f("cleaner_input.net"), o("fc.chain"), o("fc.net"),
                      f("target.2bit"), f("query.2bit"),
                      f("target.chrom.sizes"), f("query.chrom.sizes"),
                      "-minScore=50000,200000", "-minSizeT=1000,0",
                      "-minSizeQ=1000,0"])
    secs = time.monotonic() - t0
    check(counts[KERNEL] > 0, f"FilterChainsNetFilterNets never launched "
                              f"{KERNEL}")
    for ext in ("chain", "net"):
        check(same_bytes(o(f"fc.{ext}"), os.path.join(
            GOLD, f"filterChains.filtered.{ext}")),
              f"FilterChainsNetFilterNets .{ext} differs from the golden")
    print(f"[filterChains] FilterChainsNetFilterNets: byte-identical to "
          f"filterChains.filtered.chain and .net; {KERNEL} launches "
          f"{counts[KERNEL]}; {secs:.3f} s")
    return counts[KERNEL]


def phase_dryrun(dev) -> dict:
    """dryrun_multidevice on [cuda:0] * 4; returns its launches."""
    import torch

    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    from genomealignmenttools_tpu_torch.parallel.dryrun import \
        dryrun_multidevice
    perf_reset()
    t0 = time.monotonic()
    dryrun_multidevice([dev] * 4)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = dict(LAUNCHES)
    check(all(v > 0 for v in counts.values()),
          f"the dry run did not launch every kernel: {counts}")
    print(f"[dryrun] dryrun_multidevice([cuda:0] * 4): sharded scorers, "
          f"sharded cleaner, chainNet -rescore and RepeatFiller, split band "
          f"DP all exact; launches {counts}; {secs:.3f} s")
    return counts


def main() -> int:
    name, smi = phase_device()
    import torch
    dev = torch.device("cuda", 0)
    phase_build()
    worst = phase_kernel(dev)
    worst_k2 = phase_kernel_k2(dev)
    worst_k3 = phase_kernel_k3(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # the phases of earlier slices first, so that their numbers are
        # taken as before: no profiler started, no other process on the card
        phase_fixtures(tmp)
        entry, chr1 = phase_chr1(tmp, dev)
        resident = phase_resident(chr1, dev)
        k2_launches, cleaner = phase_cleaner(tmp)
        phase_gap_fixtures(tmp)
        rf = phase_repeatfiller(tmp, dev)
        k1_fc = phase_filter_chains(tmp)
        sharded = phase_sharded(chr1, resident.pop("host"), dev)
        dist_launches = phase_distributed(tmp, cleaner)
        k1_prof = phase_profile(tmp, chr1)
    dry = phase_dryrun(dev)
    entry["max_abs_err"] = max(worst, entry["max_abs_err"])
    entry["launches"] += (k1_fc + k1_prof + sharded[KERNEL]
                          + dist_launches[KERNEL] + dry[KERNEL])
    k2_entry = {"name": K2, "route": "cuda",
                "source": "genomealignmenttools_tpu_torch/csrc/combine.cu",
                "replaces": "genomealignmenttools_tpu/ops/pallas_combine.py:112",
                "launches": (k2_launches + sharded[K2] + dist_launches[K2]
                             + dry[K2]),
                "max_abs_err": max(worst_k2, resident["max_abs_err"]),
                "ms": resident["ms"], "plain_ms": resident["plain_ms"]}
    k3_entry = {"name": K3, "route": "cuda",
                "source": "genomealignmenttools_tpu_torch/csrc/band.cu",
                "replaces": "genomealignmenttools_tpu/ops/pallas_band.py:63",
                "launches": rf["launches"] + dry[K3],
                "max_abs_err": max(worst_k3, rf["max_abs_err"]),
                "ms": rf["ms"], "plain_ms": rf["plain_ms"]}
    # the engines import the jax-free parallel.distributed (shard_indices)
    # for sharded runs; parallel.mesh is the reference's jax module
    jax_like = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m.startswith("genomealignmenttools_tpu.ops.pa")
                      or m == "genomealignmenttools_tpu.parallel.mesh")
    check(not jax_like, f"jax-backed modules were loaded: {jax_like}")
    print("[jax] no jax and no jax-backed module of the reference was loaded")
    print(smi)
    print(json.dumps({"kernels": [entry, k2_entry, k3_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
