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
              print the build seconds and ptxas counts.  (The native host
              library builds from genomealignmenttools_tpu_torch/native
              with g++ at its first use, in the next phase.)
3. kernel   - K1 against its plain PyTorch version on the card, exact, on
              seeded random genomes with N runs, both strands, chunk lengths
              0, 1, 255 and 256 and chunks that end at the genome's end;
              then on tests/rescore_cases.py: every (t_off mod 16, q_off mod
              16) pair at lengths 0, 1, 15, 16, 17, 255 and 256, chunks
              ending at a genome's last byte, whole tensors and views that
              start off a 16-byte boundary, and any byte >= 4 as N.
4. kernel K2 - K2 against its plain versions on the card, exact, and K2 +
              finish against the staged int64 combine, from int32 sums and
              from int8 tiles whose rows sum to them (128 bytes a row, no
              tweak; 130 bytes, a tweak of 3), and from combined-code and
              4-bit tiles of combine_cases.code_tiles' bases at chunks 128
              and 130 (4-bit rows of 64 and 65 bytes), each with and without
              a tweak and against the int8 entry on the same bases; every
              case run twice with the same bits, on the adversarial chain
              workloads of tests/combine_cases.py: the carry's edge cases (a
              chain over more than three of K2's tiles, single-chunk chains,
              a chain ending on a tile's last chunk, pad chunks), an
              unpadded input, and 7, 800 and 200,000 random chains.
5. kernel K3 - K3 against its plain version on the card, meta and moves
              exactly, on the case sets of tests/band_cases.py: both modes at
              max_insert 7, 20 and 100, homologous, unrelated and N-run
              problems up to 2,000 bases, sides of one base, both
              directions, a band that runs off `b`, out-of-band tracebacks
              in both modes and a band centre that leaves the state arrays;
              BandExtBatch on the card against numpy band_ext on a subset,
              errors included; then both modes at a max_insert of every
              cells-per-lane count (1 to 8: every instantiation of K3).
5b. kernel K4 - K4 against its plain version on the card, exactly, on the
              edge cases of tests/hsp_cases.py (windows of 1 to 5,000 cells,
              N runs, every segment below 0, a best of exactly K), then on
              one chunk of each gap-filling cell (patchchain.gaps' 1,000
              masked-seed gaps, repeatfiller.gaps' 600, from the benchmark's
              generators): CUDA-event ms of K4 beside its bound and the
              plain version's ms, one launch; then the chunk's HSP rows
              through align_scan_batch (one K4 launch) equal to the host
              scan's, gap by gap and in order, and both paths' seconds.
6. fixtures - scoreChain, chainNet -rescore and chainCleaner through the
              port's CLI on the card, byte-compared with tests/golden; each
              must launch K1.  Then the same in pair mode (GAT_RESCORE=pair
              GAT_COMBINE=device) in each tile format (GAT_PAIR_TILES unset,
              code, score4): chainNet -rescore and chainCleaner must launch
              the format's K2 entry (its own LAUNCHES key) and no other
              kernel; in window mode no K2 entry runs.
7. goldens - the golden cases of the reference's tests that reach a scorer
              or the band batch (tests/golden_cases.py, the table
              of the tier-1 twins) through the port's CLI on the card:
              scoreChain's six cases and its nib-dir inputs, chainCleaner's
              nib-dir inputs, -net, internal netting, GAT_FUSED_BREAKS=0,
              -debug (six dumps, in the case's own working directory),
              -suspectDataFile, -onlyThis*, the meta pass-through, the six
              thresholds and -doPairs (native and python break loop),
              chainNet -rescore and FilterChainsNetFilterNets, each
              byte-identical to its goldens in window mode (K1, no K2) and
              in pair mode in each tile format (the format's K2 row source
              and no other; scoreChain launches neither); chainCleaner's
              zero-removal side effect with GAT_BREAK_LOOP 1 against 0;
              chr1-lite chainCleaner and chainNet -rescore against the C
              hashes of tests/golden/chr1_lite.json (window, int8 pair); the
              planted cases of tests/golden/planted_cases.json through the
              port's GapAligner on the card and three planted gaps through
              its RepeatFiller (K3), against construction truth.  One line
              per case and mode: goldens, launches, seconds.
8. chr1     - the bench workload (utils/bench_workload.py, 256 Mb per genome,
              384 chains, ~367 Mb aligned) through the port's scoreChain,
              byte-compared with a host-native run of the same file; cold and
              warm seconds, Mb aligned per second, K1 launches, and K1's time
              against the plain version's at the main path's shapes.
9. resident - the same chains through TorchPairChainScorer (a pass is one
              K2 launch from the int8 tiles, then the finish; the sustained
              pass is (T(41) - T(1)) / 40): every chain's (global, local)
              equal to the host-native scores, 45 K2 launches in 45 passes;
              pack, upload, single-pass and sustained per-pass times, bytes a
              pass moves against the card's published HBM bandwidth; K2
              against its plain version, exact, and both timed in turns at
              these shapes beside K2's bound;
              then the same chains in combined-code and 4-bit tiles
              (GAT_PAIR_TILES=code, score4): pack and upload seconds, 45
              launches of the format's entry in 45 passes, scores equal to
              the host-native ones, sustained ms a pass, bytes a pass, GB/s
              and share of the HBM rate, the entry against its plain
              version and K2's int8 entry on the same chunks, exact and
              timed in turns beside its bound; peak device memory.
10. cleaner  - chainNet -rescore on the chainCleaner bench workload
              (build_cleaner_workload at its defaults: 2,000 scenarios and
              30,000 bulk chains, the size of chainpair-planted-loose)
              through the port in window mode and in pair mode with the
              device combine, each byte-compared with a host-native run;
              wall seconds of all.
11. gap fixtures - RepeatFiller --refQuirks through the port's CLI on the
              card, byte-identical to tests/golden; RepeatFiller in clean
              mode and patchChain (6 arguments, with and without -unmask),
              byte-compared with the port's host band batch (GAT_BAND=host,
              in this process, no kernel); each port run must launch K3.
12. repeatfiller - build_repeatfiller_workload(n_gaps=600), the depth of
              gapfill-planted-loose, through the port's RepeatFiller (must
              launch K3) and through its host band batch (GAT_BAND=host),
              byte-compared, wall seconds of both; then the workload's
              extension problems (align_prepare) through K3 and through the
              plain version in K3's sub-batches: equal, CUDA-event ms of
              each, problem and column counts, the columns and band cells K3
              really ran and the bound they give, peak device memory.
13. filterChains - FilterChainsNetFilterNets through the port's CLI on the
              fixtures, byte-identical to tests/golden; must launch K1.
14. sharded - the chr1 chains through ShardedChainScorer on [cuda:0] * k,
              k = 1, 2, 4, and on make_mesh(): every (global, local,
              aliBases) equal to the host-native scores of phase 9, one K2
              launch per non-empty shard, seconds per k;
              ShardedBlockScorer at k = 4 on one (t, q, strand) group equal
              to the single-device K1 sums.
15. distributed - clean_chains_distributed on the cleaner workload as two
              rank subprocesses on torch.distributed, gloo with both ranks
              on cuda:0 (and nccl with one card per rank where there are
              two cards): merged chain and bed byte-identical to a
              single-process host-native chainCleaner run in this process
              (GAT_RESCORE=hostnative); wall seconds.
16. profile - the port's scoreChain on chr1 (warm) with -profile=dir, twice:
              each torch.profiler trace must name K1's kernel; summed CUDA
              kernel time, the traced window and their ratio (device-busy
              share).
17. variants - every row of tests/variant_cases.py (the table of
              tests/test_torch_variants.py's CPU twins) through the port's
              CLI with -device=cuda or its engines and scorer with a
              TorchChainScorer on the card: chr1-lite chainCleaner and
              chainNet -rescore (window, int8 pair) against the C hashes and
              RepeatFiller on 24 gaps, at GAT_THREADS=1 and =8; chainCleaner
              -numShards 2 and 3, -shard, -shardOut, then -mergeShards, and
              clean_chains and chain_net(rescore=True) with the scorer as
              scorer_factory, in window mode and each pair tile format,
              against the goldens; chainNet -rescore and chainCleaner at
              GAT_PAIR_CHUNK 2, 6, 130 and 258 in each format (4-bit rows of
              1, 3, 65 and 129 bytes), every K2 launch there held to its
              plain version on the tiles it scored, whose width is checked;
              scoreChain, chainNet -rescore and
              chainCleaner under GAT_NATIVE=0 (window, int8 pair);
              GAT_COMBINE=auto (no K2 on a chain set's first call, one on
              the repeat) and =host in each format, against the host-native
              scores and scoreChain's golden, and the int32 overflow
              fallback (PERF["combine_overflow"] + 1), against the
              host-native scores; RepeatFiller --refQuirks batched, with
              GAT_RF_BATCH=0 (one K3 launch a gap that gives the band DP
              work, each held to K3's plain version) and with
              GAT_HSP_NATIVE=0, against the golden; the 24-gap rows (both
              thread counts, GAT_RF_BATCH=0 with its first launch held to
              the plain version) against the host band batch
              (GAT_BAND=host) on the same gaps.  The
              rows of GAT_THREADS=1, =8 and GAT_NATIVE=0 run in one child
              process a setting (python3 chip_smoke.py --variants-child
              SETTING LITE_DIR RF_DIR OUT, one JSON line of hashes and
              launches), side by side, each checking that it loaded no jax.
              Each row must launch what the table says (K1 in window mode,
              the format's K2 entry and no other with the device combine,
              K3 in RepeatFiller) and nothing else.  One line per row:
              variant, mode, setting, what it is held to, launches, seconds.
18. sanitize - python -m genomealignmenttools_tpu_torch.sanitize cuda in
              this process: K1, K2's four entries and K3 in both modes at
              every instantiation on the edge cases of tests/rescore_cases.py,
              combine_cases.py and band_cases.py under memcheck, racecheck,
              synccheck and initcheck, one child process a tool, side by
              side, each with PYTORCH_NO_CUDA_MEMORY_CACHING=1 and a copy of
              the kernels built with -lineinfo; every launch held exactly to
              its plain version (computed here meanwhile, with two helper
              processes; K3's digests taken from [kernel K3]'s plain runs on
              the same inputs); the memcheck
              child also runs the fixtures' scoring tools in window mode and
              each pair tile format, RepeatFiller and patchChain, each
              byte-identical to tests/golden or the host band batch.
              compute-sanitizer must be found; it runs the four tools where
              it can attach to the card, and where it answers "Device not
              supported" (a card reached through gVisor) the kernels' own checks
              (csrc/check.cuh, the builtin checker, which always runs) carry
              the verdict.  One line a tool: errors, launches, seconds; any
              error, timeout or difference fails.  Its launches join the
              kernels line.
19. dryrun  - dryrun_multidevice([cuda:0] * 4): the sharded scorers, the
              sharded cleaner, chainNet -rescore and RepeatFiller on the
              fixtures, and the band DP split across devices, all exact.

Phases run in this order, each followed by its wall seconds.  The
host-native oracle is the port's own all-host path (the mode `hostnative` of
TorchChainScorer, the host band batch), which shares nothing with K1, K2, K3
or the torch scorers and runs in this process.  Every kernel's time stands
beside its bound: the bytes it must move at the published memory rate or its
integer operations at the int32 rate, whichever takes longer, counted from
this run's inputs.  The line before the last is a JSON object
{"kernels": [...]} whose launches sum every path's counts (each set to 0
just before the path and read just after); the last line is {"ok": true,
"device": {"platform": "gpu", ...}}.  Imports nothing of jax and nothing of
the JAX package, and checks at the end that neither was loaded.
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
K4 = "hsp_best"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 bandwidth
# 32-bit integer operations outside the tensor cores: 132 SMs x 64 lanes at
# the clock behind the published 67 TFLOP/s of float32 (128 lanes, 2 a FMA)
INT32_OPS_PER_S = 67e12 / 4
# the integer operations band_ext needs for one band cell: the match state
# (2 compares, 2 selects, 1 add), the left state (2 subtractions, 1 compare,
# 1 select), the up state (open and extend terms, the running maximum and its
# j*E offsets: 7), the three parent bits (5), the column best (2), the
# matrix index (1)
K3_OPS_PER_CELL = 25
# the integer operations K4 needs for one cell of a scan window: the LUT
# index, the running sum, the least prefix, the candidate, the best and the
# best prefix (csrc/hspscan.cu)
K4_OPS_PER_CELL = 6
# the gap-filling cells' chunks that [kernel K4] runs: cell -> gaps a chunk
K4_CELLS = {"patchchain.gaps": 1000, "repeatfiller.gaps": 600}
# K2's row sources past the int8 one: GAT_PAIR_TILES value -> the kind of
# ops/pair_combine.py, whose LAUNCHES key is pair_combine.LAUNCH_KEY[kind]
FORMATS = ("code", "score4")
# operations a tile byte of K2's row sources: the instructions of each one's
# row-sum loop (16-byte loads, the decode, the shuffles, the stores of s) over
# the tile bytes a thread reads in one trip, counted in the SASS that nvcc
# 12.8 made for sm_90a (96, 323 and 349 instructions for 64 bytes, by the
# variant script `kernel_experiments.py k2 --out` of commit a7b6c47)
OPS_PER_BYTE = {"score8": 96 / 64, "code": 323 / 64, "score4": 349 / 64}


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
    """Build or load the port's kernels; print the ptxas counts."""
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

    from genomealignmenttools_tpu_torch.device.genome import revcomp_codes
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


def roofline(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: every byte once at the published
    memory rate, or the operations at the int32 rate, whichever is larger."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * n_ops / INT32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_kernel(dev) -> int:
    """Exact kernel == plain on the card; returns the max abs difference."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from rescore_cases import alignment_case, direct_sums
    from genomealignmenttools_tpu_torch.ops import window_rescore as wr
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
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
    # every (t_off mod 16, q_off mod 16) pair at lengths 0, 1, 15, 16, 17,
    # 255, 256, chunks ending at a genome's last byte; whole tensors, then
    # views that start off a 16-byte boundary; then any byte >= 4 as N
    t, q, t_off, q_off, length = alignment_case()
    want = direct_sums(t, q, lut.numpy(), t_off, q_off, length)
    for label, cut_t, cut_q in (("whole", 0, 0), ("offset views", 3, 9)):
        keep = (t_off >= cut_t) & (q_off >= cut_q)
        card = [torch.from_numpy(a).to(dev) for a in (
            t, q, t_off[keep] - cut_t, q_off[keep] - cut_q, length[keep])]
        card[0], card[1] = card[0][cut_t:], card[1][cut_q:]
        got = wr.chunk_sums(card[0], card[1], lut, *card[2:])
        plain = wr.chunk_sums_plain(card[0], card[1], lut, *card[2:])
        torch.cuda.synchronize()
        diff = max(int((got.to(torch.int64) - plain.to(torch.int64)).abs()
                       .max()),
                   int(np.abs(got.cpu().numpy().astype(np.int64)
                              - want[keep]).max()))
        worst = max(worst, diff)
        check(diff == 0, f"kernel != plain on the alignment set ({label}, "
                         f"max {diff})")
    t, q = t.copy(), q.copy()
    for codes in (t, q):
        at = rng.integers(0, codes.shape[0], 3000)
        codes[at] = rng.integers(4, 256, at.shape[0]).astype(np.uint8)
    card = [torch.from_numpy(a).to(dev) for a in (t, q, t_off, q_off, length)]
    got = wr.chunk_sums(card[0], card[1], lut, *card[2:])
    diff = int(np.abs(got.cpu().numpy().astype(np.int64) - direct_sums(
        t, q, lut.numpy(), t_off, q_off, length)).max())
    worst = max(worst, diff)
    check(diff == 0, f"kernel != definition with bytes >= 4 (max {diff})")
    print(f"[kernel] {len(length)} chunks of every (t_off, q_off) alignment "
          f"mod 16 at lengths 0, 1, 15, 16, 17, 255, 256, ending at the last "
          f"byte, on whole tensors and offset views, any byte >= 4 as N: "
          f"kernel == plain == definition exactly")
    return worst


def max_diff(*pairs) -> int:
    """The largest |a - b| over pairs of integer tensors on one device."""
    import torch
    torch.cuda.synchronize()
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in pairs)


def k2_against_plain(s, bias, flags, start_idx, end_idx, tiles=None,
                     tweak=None, kind="score8", table=None, s8=None) -> int:
    """K2 == its plain version, twice with the same bits, and K2 + finish ==
    the staged int64 combine of s (+ tweak), on one set of card tensors:
    from the int32 sums s, or, given `tiles` of the format `kind` whose rows
    sum to s, from the tiles; given `s8`, the int8 tiles of the same bases,
    K2's int8 entry on them too.  Returns the max abs difference."""
    import torch

    from genomealignmenttools_tpu_torch.ops import pair_combine as pc
    from genomealignmenttools_tpu_torch.ops.pair_rescore import \
        pair_chain_scores_plain
    if tiles is None:
        run, plain, args = pc.pair_combine_scan, pc.pair_combine_scan_plain, (
            s, bias, flags)
    else:
        run, plain = pc.pair_combine_scan_tiles, pc.pair_combine_scan_tiles_plain
        args = (tiles, bias, flags, tweak, kind, table)
    c, w = run(*args)
    c2, w2 = run(*args)
    c_plain, w_plain = plain(*args)
    pairs = [(c, c_plain), (w, w_plain), (c, c2), (w, w2)]
    if s8 is not None:
        c8, w8 = pc.pair_combine_scan_tiles(s8, bias, flags, tweak)
        pairs += [(c, c8), (w, w8)]
    fin = pc.pair_combine_finish(c, w, end_idx).to(torch.int64)
    s_tw = s if tweak is None else (s + tweak).to(torch.int32)
    staged = pair_chain_scores_plain(s_tw, bias, flags, start_idx, end_idx)
    return max_diff(*pairs, (fin, staged))


def format_tiles(kind: str, codes, idx_lut25):
    """The tiles of `kind` for the combined codes `codes` (torch, on the
    card): the codes themselves, or their 4-bit indices."""
    from combine_cases import nibble_tiles
    return codes if kind == "code" else nibble_tiles(codes, idx_lut25)


def phase_kernel_k2(dev) -> tuple[int, dict]:
    """Exact K2 == plain (and == staged), every entry, on the card; returns
    the max abs difference of the int32 and int8 entries and of each other
    row source."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from combine_cases import (WIDE_LUT, code_tiles, code_tiles_torch,
                               combine_case, edge_chains, even_tiles_torch,
                               random_chains, score_tiles, scored_tiles)
    from genomealignmenttools_tpu_torch.ops.pair_combine import TILE
    from genomealignmenttools_tpu_torch.ops.pair_rescore import (pack_vals16,
                                                                 vals16_of)
    IDX_LUT25, vals_packed = pack_vals16(WIDE_LUT)
    TABLES = {"code": torch.from_numpy(WIDE_LUT.reshape(25).astype(np.int8)),
              "score4": torch.from_numpy(vals16_of(vals_packed))}
    by_kind = {kind: 0 for kind in FORMATS}

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
        check(diff == 0, f"K2 != plain or staged on {label} (max {diff})")
        # the tile entry: at the default width (16-byte loads) with no
        # tweak, and at 130 bytes a row (a row a thread) with a tweak; rows
        # built on the card where the host would take long
        for chunk, tweak in ((128, None), (130, 3)):
            if s.shape[0] > 1 << 21:
                tiles = even_tiles_torch(card[0], chunk)
            else:
                tiles = torch.from_numpy(score_tiles(rng, s, chunk)).to(dev)
            tw = (None if tweak is None else
                  torch.tensor(tweak, dtype=torch.int32, device=dev))
            d = k2_against_plain(*card, tiles=tiles, tweak=tw)
            check(d == 0, f"K2 (tiles of {chunk}, tweak {tweak}) != plain or "
                          f"staged on {label} (max {d})")
            diff = max(diff, d)
            del tiles
        # the other row sources, on the bases of combine_cases.code_tiles
        # (rows built on the card where the host would take long), at chunk
        # 128 (16-byte loads) and 130 (a row a thread; 65 bytes of nibbles),
        # with and without a tweak, each against its plain version, K2's
        # int8 entry on the same bases and the staged combine of their sums
        for chunk in (128, 130):
            if s.shape[0] > 1 << 21:
                codes = code_tiles_torch(s.shape[0], chunk, dev, seed=chunk)
            else:
                codes = code_tiles(rng, s.shape[0], chunk)
                codes[m:] = 24
                codes = torch.from_numpy(codes).to(dev)
            s8 = scored_tiles(codes, WIDE_LUT)
            s_f = s8.sum(dim=1, dtype=torch.int32)
            for kind in FORMATS:
                tiles = format_tiles(kind, codes, IDX_LUT25)
                for tweak in (None, 3):
                    tw = (None if tweak is None else
                          torch.tensor(tweak, dtype=torch.int32, device=dev))
                    d = k2_against_plain(s_f, *card[1:], tiles=tiles,
                                         tweak=tw, kind=kind,
                                         table=TABLES[kind], s8=s8)
                    check(d == 0, f"K2 ({kind} tiles of {chunk} bases, tweak "
                                  f"{tweak}) != plain, int8 or staged on "
                                  f"{label} (max {d})")
                    by_kind[kind] = max(by_kind[kind], d)
                del tiles
            del codes, s8, s_f
        worst = max(worst, diff)
        print(f"[kernel K2] {label}: {len(end_idx)} chains, {m} chunks + "
              f"{s.shape[0] - m} pad, {-(-s.shape[0] // TILE)} tiles of "
              f"{TILE}; longest chain {int(lengths.max())} chunks, "
              f"{int((lengths == 1).sum())} single-chunk chains, "
              f"{int((end_idx % TILE == TILE - 1).sum())} ending on a "
              f"tile's last chunk: from int32 sums and from int8 tiles of "
              f"128 (no tweak) and 130 bytes (tweak 3); from code tiles of "
              f"128 and 130 bytes and 4-bit tiles of 64 and 65 bytes, each "
              f"with no tweak and a tweak of 3: each run twice with the same "
              f"bits, kernel == plain (== the int8 entry on the same bases) "
              f"and finish == staged exactly")
        del card
    return worst, by_kind


def run_cli(args: list[str], env: dict | None = None) -> dict:
    """One port CLI run on the card, with `env` set for it; returns its
    launch counts (set to 0 just before, read just after)."""
    import torch

    from genomealignmenttools_tpu_torch.cli.main import main
    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    with golden_cases().environ(env or {}):
        perf_reset()
        rc = main(args + ["-device=cuda"])
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    check(rc == 0, f"CLI {args[0]} exited {rc}")
    return counts


def golden_cases():
    """tests/golden_cases.py: the twins' case table and the scoring modes'
    environments (MODES); it imports only the standard library."""
    if os.path.join(REPO, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(REPO, "tests"))
    import golden_cases as gc
    return gc


def mode_keys() -> dict:
    """The LAUNCHES key each scoring mode of golden_cases.MODES must launch:
    K1 in window mode, in a pair mode the K2 row source of its tile format
    (pair_combine.LAUNCH_KEY; GAT_PAIR_TILES unset is int8, score8)."""
    from genomealignmenttools_tpu_torch.ops.pair_combine import LAUNCH_KEY
    return {mode: KERNEL if mode == "window" else
            LAUNCH_KEY[env["GAT_PAIR_TILES"] or "score8"]
            for mode, env in golden_cases().MODES.items()}


def check_launches(label: str, tool: str, mode: str, counts: dict) -> None:
    """Window mode launches K1 and no K2 row source; a pair mode launches
    the row source of its tile format and no other, except scoreChain, which
    takes score_table and the native combine there (as the reference does)
    and launches neither kernel."""
    keys = mode_keys()
    key = keys[mode]
    scores_on_k2 = mode != "window" and tool != "scoreChain"
    if mode == "window" or scores_on_k2:
        check(counts[key] > 0, f"{label} ({mode}) never launched {key}")
    others = [k for k in keys.values() if k not in (key, KERNEL)]
    if mode != "window":
        others.append(KERNEL)
    check(not any(counts[k] for k in others),
          f"{label} ({mode}) launched another kernel: {counts}")


def phase_fixtures(tmp: str) -> dict:
    """The three tools on the fixtures in window mode (K1), then in pair mode
    with the device combine in each tile format (K2's row source of the
    format and no other; scoreChain takes score_table and the native combine
    there, as in the reference, and launches neither kernel).  Returns the
    launches of the code and 4-bit row sources."""
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
    from genomealignmenttools_tpu_torch.ops.pair_combine import LAUNCH_KEY
    keys = mode_keys()
    launches = {LAUNCH_KEY[kind]: 0 for kind in FORMATS}
    for mode, env in golden_cases().MODES.items():
        for label, args, pairs in runs:
            t0 = time.monotonic()
            counts = run_cli(args, env)
            secs = time.monotonic() - t0
            check_launches(label, args[0], mode, counts)
            if keys[mode] in launches:
                launches[keys[mode]] += counts[keys[mode]]
            for got, want in pairs:
                check(same_bytes(got, want),
                      f"{label} ({mode}): {got} != {want}")
            print(f"[fixtures] {label} ({mode} mode): byte-identical to "
                  f"{', '.join(os.path.basename(w) for _, w in pairs)}; "
                  + ", ".join(f"{k} launches {v}" for k, v in counts.items())
                  + f"; {secs:.3f} s")
    return launches


def phase_goldens(tmp: str, dev) -> dict:
    """The reference's golden cases that reach a scorer or the band batch,
    on the card (tests/golden_cases.py, the tier-1 twins' table):
    every scoring case through the port's CLI in window mode and in pair
    mode in each tile format, byte-identical to its goldens; chainCleaner's
    zero-removal side effect with GAT_BREAK_LOOP 1 against 0; chr1-lite
    chainCleaner and chainNet -rescore against the C binaries' hashes
    (window, int8 pair); the planted cases through the port's GapAligner on
    the card and three planted gaps through its RepeatFiller, against
    construction truth.  Returns the launches of each kernel."""
    import torch

    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    gc = golden_cases()
    total = dict.fromkeys(mode_keys().values(), 0)
    total[K3] = 0
    by_mode: dict = {}     # mode -> [runs, seconds]

    def record(label, mode, counts, held_to, secs):
        runs = by_mode.setdefault(mode, [0, 0.0])
        runs[0] += 1
        runs[1] += secs
        for k in total:
            total[k] += counts[k]
        launched = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        print(f"[goldens] {label} ({mode}): {held_to}; launches "
              f"{launched or 'none'}; {secs:.3f} s")

    for mode in gc.MODES:
        for case in gc.scoring_cases(""):
            out = os.path.join(tmp, "goldens", mode, case)
            os.makedirs(out)
            argv, env, outputs = gc.scoring_cases(out)[case]
            t0 = time.monotonic()
            with contextlib.chdir(out):
                counts = run_cli(argv, {**gc.MODES[mode], **env})
            secs = time.monotonic() - t0
            for got, golden in outputs:
                diff = gc.first_difference(got, golden)
                check(diff is None, f"{case} ({mode}): {diff}")
            check_launches(case, argv[0], mode, counts)
            record(case, mode, counts, "byte-identical to " + ", ".join(
                os.path.basename(g) if g else "an empty file"
                for _, g in outputs), secs)
        # tests/test_chain_cleaner_parity.py:168-212, both loops on the card
        out = os.path.join(tmp, "goldens", mode, "zero_removal")
        perturbed = gc.perturbed_input(out + ".chain")
        texts = {}
        for loop in ("1", "0"):
            os.makedirs(os.path.join(out, loop))
            t0 = time.monotonic()
            counts = run_cli(gc.zero_removal_argv(
                out + ".chain", os.path.join(out, loop)),
                {**gc.MODES[mode], "GAT_BREAK_LOOP": loop})
            secs = time.monotonic() - t0
            check_launches("chain_cleaner_parity-zero_removal", "chainCleaner",
                           mode, counts)
            texts[loop] = []
            for name in ("c.chain", "c.bed"):
                with open(os.path.join(out, loop, name)) as fh:
                    texts[loop].append(fh.read())
            check(texts[loop][1] == "", f"zero removal ({mode}, "
                                        f"GAT_BREAK_LOOP={loop}) removed")
            record(f"chain_cleaner_parity-zero_removal_score_side_effect, "
                   f"GAT_BREAK_LOOP={loop}", mode, counts,
                   "nothing removed", secs)
        check(texts["1"] == texts["0"] and texts["1"][0] != perturbed,
              f"zero removal ({mode}): GAT_BREAK_LOOP 1 and 0 differ, or the "
              f"scores were not rewritten")
        print(f"[goldens] chain_cleaner_parity-zero_removal_score_side_effect "
              f"({mode}): GAT_BREAK_LOOP 1 and 0 byte-identical, every "
              f"perturbed score rewritten")

    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_cleaner_workload
    t0 = time.monotonic()
    lite = build_cleaner_workload(os.path.join(tmp, "goldens", "lite"),
                                  n_scenarios=gc.LITE_SCENARIOS,
                                  n_bulk=gc.LITE_BULK)
    print(f"[goldens] chr1-lite workload ({gc.LITE_SCENARIOS} scenarios + "
          f"{gc.LITE_BULK} bulk chains) built in {time.monotonic() - t0:.3f} "
          f"s (set-up)")
    hashes = gc.lite_hashes()
    for mode in ("window", "pair"):
        for case, (argv, outputs) in gc.lite_cases(
                lite, os.path.join(tmp, "goldens", "lite")).items():
            t0 = time.monotonic()
            counts = run_cli(argv, gc.MODES[mode])
            secs = time.monotonic() - t0
            for path, key in outputs:
                check(gc.sha256(path) == hashes[key],
                      f"{case} ({mode}): {path} is not the C hash {key}")
            check_launches(case, argv[0], mode, counts)
            record(case, mode, counts, "the C hashes " + ", ".join(
                k for _, k in outputs), secs)

    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.ops.seed_extend import GapAligner
    sch = score_scheme_default()
    aligner = GapAligner(sch.lut, seed_len=10, hsp_threshold=1500,
                         gapped_threshold=2000, gap_open=sch.gap_open,
                         gap_extend=sch.gap_extend,
                         char_matrix=sch.char_matrix(), device=dev)
    for case in gc.planted_cases():
        name = case["spec"]["name"]
        t, q, _ = gc.build_planted(name)
        perf_reset()
        t0 = time.monotonic()
        got = aligner.align(t, q, 0, t.shape[0], 0, q.shape[0])
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = dict(LAUNCHES)
        problem = gc.planted_recovery_problem(name, case["planted_blocks"],
                                              got)
        check(problem is None, f"planted {name}: {problem}")
        check((counts[K3] > 0) == bool(got),
              f"planted {name}: {len(got)} blocks, {counts}")
        record(f"planted_alignment-planted_recovery[{name}]", "GapAligner",
               counts, "the planted blocks of planted_cases.json", secs)
    for case, name in gc.PLANTED_GAPS.items():
        chain, t2, q2, planted = gc.planted_gap_inputs(
            name, os.path.join(tmp, "goldens", name))
        out = os.path.join(tmp, "goldens", name, "out.chain")
        t0 = time.monotonic()
        counts = run_cli(["RepeatFiller", "-c", chain, "-T2", t2, "-Q2", q2,
                          "-o", out])
        secs = time.monotonic() - t0
        with open(out) as fh:
            problem = gc.planted_gap_problem(case, chain, fh.read(), planted)
        check(problem is None, f"{case}: {problem}")
        check(counts[K3] > 0, f"{case} never launched {K3}")
        record(case, "RepeatFiller", counts, "the splice construction truth "
               "demands", secs)
    print(f"[goldens] {sum(r[0] for r in by_mode.values())} runs, every one "
          f"byte-identical to its golden, C hash or construction truth; "
          f"launches {total}; runs and seconds by mode: "
          + ", ".join(f"{m} {r[0]} in {r[1]:.3f} s" for m, r in
                      by_mode.items()))
    return total


def host_native_factory():
    """The port's all-host scorer, TorchChainScorer in the mode `hostnative`
    (threaded C++ LUT sums, gat_subset_scores, the native combine): no
    device, no kernel and no torch scorer, so it is the oracle of the card
    runs, in this process."""
    from genomealignmenttools_tpu_torch.ops.rescore import \
        torch_scorer_factory
    return torch_scorer_factory(mode="hostnative")


def main_path_chunks(meta: dict, dev):
    """The chunk descriptors the port's scoreChain builds for this chain
    file: one job per (t, q, strand) group, rows in file order."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu_torch.device.genome import open_genome
    from genomealignmenttools_tpu_torch.native.chain_io import parse_chain_table
    from genomealignmenttools_tpu_torch.ops.window_rescore import (
        chunk_blocks, upload_codes)
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
        # genomes as TorchGenomeCache holds them: padded to 16 bytes
        jobs.append([upload_codes(t_gen.codes(t_names[key[0]], "+"), dev),
                     upload_codes(q_gen.codes(q_names[key[1]], strand), dev),
                     *[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (t_off, q_off, length)]])
    return jobs


def phase_chr1(tmp: str, dev, t_size: int = 256_000_000,
               n_chains: int = 384) -> tuple[dict, dict]:
    """Returns K1's kernels-line entry and the workload's paths."""
    import torch

    from genomealignmenttools_tpu_torch.engines.score_chain import score_chain_file
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.utils.bench_workload import build_workload
    from genomealignmenttools_tpu_torch.utils.profiling import (phase_acc_start,
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
                     linear_gap="loose", scorer_factory=host_native_factory())
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
    # the bound: each code byte of both genomes once, 20 descriptor bytes
    # in and 4 out a chunk; one lookup and one add a base
    n_bases = sum(int(j[4].sum()) for j in jobs)
    n_bytes = 2 * n_bases + 24 * n_chunks
    bound = roofline(n_bytes, 2 * n_bases)
    print(f"[chr1] K1 at main-path shapes ({len(jobs)} launches, {n_chunks} "
          f"chunks, {mb:.3f} Mb): kernel {ms['kernel']} ms, plain "
          f"{ms['plain']} ms, wrapper with bounds check {ms['wrapper']} ms; "
          f"kernel == plain exactly")
    print(f"[chr1] K1 bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}"
          f": {n_bytes} bytes ({2 * n_bases} of codes, {24 * n_chunks} of "
          f"descriptors and sums) at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"{2 * n_bases} integer operations at "
          f"{INT32_OPS_PER_S / 1e12:.2f} T/s; the kernel reaches "
          f"{100 * bound['bound_ms'] / min(ms['kernel']):.1f}% of it; "
          f"library call: none (a ragged gather, a LUT and a segment sum "
          f"are several PyTorch calls: the plain version)")
    entry = {"name": KERNEL, "route": "cuda",
             "source": "genomealignmenttools_tpu_torch/csrc/rescore.cu",
             "replaces": "genomealignmenttools_tpu/ops/pallas_rescore.py:43",
             "launches": launches, "max_abs_err": worst,
             "ms": min(ms["kernel"]), "plain_ms": min(ms["plain"]),
             **bound, "library_ms": None}
    return entry, meta


def timed(fn):
    t0 = time.monotonic()
    out = fn()
    return time.monotonic() - t0, out


def phase_resident(meta: dict, dev) -> dict:
    """The chr1 chains through TorchPairChainScorer: a first pass, three
    single passes and 41 chained ones, the sustained pass (T(41) - T(1)) /
    40; returns K2's times, error and launches."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu_torch.device.genome import open_genome
    from genomealignmenttools_tpu_torch.formats.chain import read_chains
    from genomealignmenttools_tpu_torch.formats.gapcalc import gap_calc_from_file
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.native.chain_io import parse_chain_table
    from genomealignmenttools_tpu_torch.utils.profiling import (phase_acc_start,
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
    host_rows = host_native_factory()(scheme, gap_calc, t_gen,
                                      q_gen).score_table(table)
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
    print(f"[resident] single pass (K2 from the tiles + finish + fetch) "
          f"{min(singles) * 1e3:.3f} ms (of {[round(x * 1e3, 3) for x in singles]}"
          f"); sustained {per_pass * 1e3:.4f} ms per pass = (T(41) "
          f"{t41 * 1e3:.3f} ms - T(1)) / 40, {mb / per_pass / 1e3:.3f} Gb "
          f"aligned/s")
    print(f"[resident] resident_hbm_bytes {hbm} ({hbm / 1e6:.3f} MB) per "
          f"pass: {hbm / per_pass / 1e9:.3f} GB/s sustained, "
          f"{100 * hbm / per_pass / HBM_BYTES_PER_S:.2f}% of the published "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    tiles, bias, flags = pack.tiles, pmeta.bias, pmeta.flags
    s = tiles.sum(dim=1, dtype=torch.int32)
    start_idx = torch.from_numpy(pmeta.start_idx).to(dev)
    one = torch.tensor(1, dtype=torch.int32, device=dev)
    worst = max(k2_against_plain(s, bias, flags, start_idx, pmeta.end_idx,
                                 tiles=tiles, tweak=tw) for tw in (None, one))
    check(worst == 0, f"K2 != plain at resident shapes (max {worst})")
    ms = {}
    # in turns: plain, kernel, kernel, plain
    for label, fn, reps in (
            ("plain", pc.pair_combine_scan_tiles_plain, 3),
            ("kernel", pc._launch_tiles, 50),
            ("kernel", pc._launch_tiles, 50),
            ("plain", pc.pair_combine_scan_tiles_plain, 3)):
        ms.setdefault(label, []).append(
            cuda_ms(lambda fn=fn: fn(tiles, bias, flags), reps))
    row_ms = cuda_ms(lambda: tiles.sum(dim=1, dtype=torch.int32), 50)
    s_ms = cuda_ms(lambda: pc._launch_kernel(s, bias, flags), 50)
    rows = tiles.shape[0]
    n_bytes = tiles.numel() + 16 * rows
    print(f"[resident] K2 at these shapes ({rows} chunks of {tiles.shape[1]} "
          f"bytes, {-(-rows // pc.TILE)} tiles of {pc.TILE}), in turns: "
          f"kernel (one launch from the int8 tiles) {ms['kernel']} ms; "
          f"plain {ms['plain']} ms; kernel == plain exactly, with and "
          f"without a tweak.  Apart: the torch row sums alone {row_ms:.4f} "
          f"ms, the kernel's int32-s entry {s_ms:.4f} ms")
    # the bound: every tile byte, bias and flags read once, c and w written
    # once; the row-sum loop's operations a byte and about six a chunk for
    # the scans
    bound = roofline(n_bytes, OPS_PER_BYTE["score8"] * tiles.numel()
                     + 6 * rows)
    print(f"[resident] K2 bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}: {n_bytes} bytes ({tiles.numel()} of tiles, "
          f"16 a chunk of bias, flags, c and w) at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the kernel reaches "
          f"{100 * bound['bound_ms'] / min(ms['kernel']):.1f}% of it; "
          f"library call: none (three dependent segmented scans; torch.cumsum "
          f"and cummax are not segmented)")
    formats = {kind: resident_format(kind, chains, scheme, gap_calc, t_gen,
                                     q_gen, dev, host_rows, tiles)
               for kind in FORMATS}
    print(f"[resident] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return {"ms": min(ms["kernel"]), "plain_ms": min(ms["plain"]),
            "max_abs_err": worst, **bound, "library_ms": None,
            "launches": launches, "formats": formats,
            "host": [(g, loc, int(a)) for g, loc, a in host_rows.tolist()]}


def resident_format(kind: str, chains, scheme, gap_calc, t_gen, q_gen, dev,
                    host_rows, int8_tiles) -> dict:
    """The resident protocol of phase_resident with GAT_PAIR_TILES=kind:
    pack, upload, metadata, 45 chained passes (each one launch of the
    format's K2 entry) equal to the host-native scores; then the entry
    against its plain version and against K2's int8 entry on the int8 tiles
    of the same chunks, exactly, with and without a tweak, and the three
    timed in turns beside the entry's bound.  Returns its kernels-line
    numbers."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    from genomealignmenttools_tpu_torch.ops import pair_combine as pc
    from genomealignmenttools_tpu_torch.ops.pair_rescore import \
        TorchPairChainScorer
    from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
    from genomealignmenttools_tpu_torch.utils.profiling import (phase_acc_start,
                                                         phase_acc_stop)
    key = pc.LAUNCH_KEY[kind]
    with golden_cases().environ({"GAT_PAIR_TILES": kind}):
        scorer = TorchChainScorer(scheme, gap_calc, t_gen, q_gen, device=dev,
                                  mode="pair")
    check(scorer._dev.kind == kind, f"GAT_PAIR_TILES={kind} gave "
                                    f"{scorer._dev.kind} tiles")
    pcs = TorchPairChainScorer(scorer._dev, gap_calc)
    jobs, order = scorer._grouped(chains)
    nblocks = [chains[i].n_blocks for i in order]
    torch.cuda.synchronize()
    phase_acc_start()
    pack = scorer._dev._pack(jobs)
    torch.cuda.synchronize()
    phases = phase_acc_stop()
    meta_s, pmeta = timed(lambda: pcs._meta(jobs, nblocks))
    tiles, table, bias, flags = pack.tiles, pack.table, pmeta.bias, pmeta.flags
    up = phases["rescore: pair tiles to device"]
    print(f"[resident {kind}] {pack.m} chunks ({tiles.shape[0]} rows of "
          f"{tiles.shape[1]} bytes with pads): host pack "
          f"{phases['rescore: pair pack']:.4f} s, upload of "
          f"{tiles.numel() / 1e6:.3f} MB {up:.4f} s "
          f"({tiles.numel() / up / 1e9:.3f} GB/s), scan metadata "
          f"{meta_s:.4f} s (set-up, once per chain set)")
    perf_reset()
    out0 = pcs.score_chained(jobs, nblocks, 1)
    singles = []
    for _ in range(3):
        dt, out = timed(lambda: pcs.score_chained(jobs, nblocks, 1))
        check(np.array_equal(out, out0), f"resident {kind} pass is not "
                                         f"repeatable")
        singles.append(dt)
    t41, out41 = timed(lambda: pcs.score_chained(jobs, nblocks, 41))
    check(np.array_equal(out41, out0), f"chained {kind} passes changed the "
                                       f"scores")
    per_pass = (t41 - min(singles)) / 40
    launches = LAUNCHES[key]
    check(launches == 45 and LAUNCHES[K2] == 0,
          f"resident {kind} passes launched {key} {launches} times and "
          f"{K2} {LAUNCHES[K2]} times")
    host = host_rows[np.asarray(order)]
    check(np.array_equal(out0.astype(np.float64), host[:, :2]),
          f"resident {kind} (global, local) differ from the host-native "
          f"scores")
    check(pcs.score(jobs, nblocks) == [(g, loc, int(a)) for g, loc, a in
                                       host.tolist()],
          f"TorchPairChainScorer.score ({kind}) differs from the host-native "
          f"scores")
    hbm = pcs.resident_hbm_bytes(jobs, nblocks)
    print(f"[resident {kind}] every chain's (global, local, aliBases) equals "
          f"the host-native scores; {key} launches {launches} in 45 passes, "
          f"{K2} none; single pass {min(singles) * 1e3:.3f} ms (of "
          f"{[round(x * 1e3, 3) for x in singles]}); sustained "
          f"{per_pass * 1e3:.4f} ms per pass; resident_hbm_bytes {hbm} "
          f"({hbm / 1e6:.3f} MB) per pass: {hbm / per_pass / 1e9:.3f} GB/s, "
          f"{100 * hbm / per_pass / HBM_BYTES_PER_S:.2f}% of the published "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    check(int8_tiles.shape[0] == tiles.shape[0], "int8 and format packs "
                                                 "differ in rows")
    s = pc.tile_row_sums(tiles, kind, table)
    start_idx = torch.from_numpy(pmeta.start_idx).to(dev)
    one = torch.tensor(1, dtype=torch.int32, device=dev)
    worst = max(k2_against_plain(s, bias, flags, start_idx, pmeta.end_idx,
                                 tiles=tiles, tweak=tw, kind=kind,
                                 table=table, s8=int8_tiles)
                for tw in (None, one))
    check(worst == 0, f"K2 ({kind}) != plain or the int8 entry at resident "
                      f"shapes (max {worst})")
    ms = {}
    # in turns: plain, int8 entry, the format's entry, twice over
    runs = {"plain": (lambda: pc.pair_combine_scan_tiles_plain(
                tiles, bias, flags, None, kind, table), 3),
            "int8 K2": (lambda: pc._launch_tiles(int8_tiles, bias, flags),
                        50),
            "kernel": (lambda: pc._launch_tiles(tiles, bias, flags, None,
                                                kind, table), 50)}
    for label in ("plain", "int8 K2", "kernel", "kernel", "int8 K2",
                  "plain"):
        fn, reps = runs[label]
        ms.setdefault(label, []).append(cuda_ms(fn, reps))
    rows = tiles.shape[0]
    n_bytes = tiles.numel() + 16 * rows
    bound = roofline(n_bytes, OPS_PER_BYTE[kind] * tiles.numel() + 6 * rows)
    print(f"[resident {kind}] K2's {kind} entry at these shapes ({rows} "
          f"chunks of {tiles.shape[1]} bytes), in turns: kernel "
          f"{ms['kernel']} ms; the int8 entry on the same chunks' int8 tiles "
          f"{ms['int8 K2']} ms; plain {ms['plain']} ms; kernel == plain == "
          f"the int8 entry exactly, with and without a tweak")
    print(f"[resident {kind}] bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}: {n_bytes} bytes ({tiles.numel()} of tiles, "
          f"16 a chunk of bias, flags, c and w) at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"{OPS_PER_BYTE[kind] * tiles.numel() + 6 * rows:.0f} integer "
          f"operations ({OPS_PER_BYTE[kind]} a tile byte, 6 a chunk) at "
          f"{INT32_OPS_PER_S / 1e12:.2f} T/s; the kernel reaches "
          f"{100 * bound['bound_ms'] / min(ms['kernel']):.1f}% of it; library "
          f"call: none")
    del scorer, pcs, pack, tiles, s
    return {"ms": min(ms["kernel"]), "plain_ms": min(ms["plain"]),
            "int8_ms": min(ms["int8 K2"]), "max_abs_err": worst, **bound,
            "library_ms": None, "launches": launches}


def phase_cleaner(tmp: str, n_scenarios: int = 2000,
                  n_bulk: int = 30000) -> tuple[int, dict]:
    """chainNet -rescore on the chainCleaner bench workload at its default
    size through the port in window and pair mode, byte-compared with a
    host-native run; returns K2's launches in the pair run and the
    workload."""
    from genomealignmenttools_tpu_torch.engines.chain_net import chain_net
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
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
                      linear_gap="loose",
                      scorer_factory=host_native_factory())
        return time.monotonic() - t0

    secs = {"host-native (cold: decodes both genomes)":
            host_native("host")}
    counts = {}
    modes = golden_cases().MODES
    for tag, env in (("window", None), ("pair", modes["pair"])):
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
                     max_insert) -> tuple[int, "object", str]:
    """K3 == band_ext_plain on one set of card inputs; returns the max abs
    difference over meta and moves, K3's meta and the digest of the plain
    version's outputs (sanitize.digest)."""
    from genomealignmenttools_tpu_torch.sanitize import digest
    import torch

    from genomealignmenttools_tpu_torch.ops import band_batch as bb
    got = bb.band_ext_cuda(*args, mat, global_mode, gap_open, gap_extend,
                           max_insert)
    want = bb.band_ext_plain(*args, mat, global_mode, gap_open, gap_extend,
                             max_insert)
    torch.cuda.synchronize()
    diff = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))
    return diff, got[0], digest(want)


def phase_kernel_k3(dev) -> tuple[int, dict]:
    """Exact K3 == plain on the card on every case set, and BandExtBatch on
    the card == numpy band_ext on a subset; returns the max abs difference
    and the plain version's digest of each set, by [sanitize]'s label."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from band_cases import (instantiation_cases, kernel_cases, outcome,
                            raw_inputs)
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.ops.band_ext import band_ext
    from genomealignmenttools_tpu_torch.ops import band_batch as bb

    cm = score_scheme_default().char_matrix()
    worst, errs, n_oracle, plain = 0, set(), 0, {}
    for label, g, gap_open, gap_extend, mi, probs in kernel_cases():
        batch = bb.BandExtBatch(g, cm, gap_open, gap_extend, mi, device=dev)
        args = raw_inputs(probs, dev)
        diff, meta, plain[f"K3 {label}"] = k3_against_plain(
            args, batch.mat, g, gap_open, gap_extend, mi)
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
    # one max_insert for every cells-per-lane count: every instantiation
    seen = set()
    for label, g, gap_open, gap_extend, mi, probs in instantiation_cases():
        batch = bb.BandExtBatch(g, cm, gap_open, gap_extend, mi, device=dev)
        diff, meta, plain[f"K3 {label}"] = k3_against_plain(
            raw_inputs(probs, dev), batch.mat, g, gap_open, gap_extend, mi)
        worst = max(worst, diff)
        check(diff == 0, f"K3 != plain on {label} (max {diff})")
        seen.add(bb.parent_layout(mi)[0])
        print(f"[kernel K3] {label}: {meta.shape[0]} problems, "
              f"{int((meta[:, 0] != 0).sum())} aligned: kernel == plain "
              f"exactly")
    check(seen == set(range(1, 9)), f"instantiations run: {sorted(seen)}")
    print(f"[kernel K3] BandExtBatch on the card == numpy band_ext on "
          f"{n_oracle} problems (tuples, AssertionError and IndexError)")
    return worst, plain


def phase_kernel_k4(tmp: str, dev) -> dict:
    """K4 against its plain version on the card, exact, on the edge cases
    of tests/hsp_cases.py and on one chunk of each gap-filling cell (its
    benchmark generator and configuration, seed 2500000001): CUDA-event ms
    of K4, the plain version's ms, the bound, the launches; then the
    chunk's HSP rows through align_scan_batch (one K4 launch) against the
    host scan's, gap by gap.  Returns the kernels-line numbers of
    patchchain.gaps' chunk."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import hsp_cases as hc
    from genomealignmenttools_tpu_torch.device import (LAUNCHES, PERF,
                                                       perf_reset)
    from genomealignmenttools_tpu_torch.ops import hsp_scan as hs
    from genomealignmenttools_tpu_torch.ops.seed_extend import pack_windows

    def on_card(t, q, t_start, q_start, length):
        return [torch.from_numpy(a).to(dev)
                for a in (t, q, t_start, q_start, length)]

    lut = torch.from_numpy(hc.hsp_lut().astype(np.int32))
    t, q, ts, qs, ln = args = on_card(*hc.edge_case())
    got = hs.hsp_best(t, q, lut, ts, qs, ln)
    want = hs.hsp_best_plain(t, q, lut, ts, qs, ln)
    torch.cuda.synchronize()
    worst = int((got.long() - want.long()).abs().max())
    check(worst == 0, f"K4 != plain on the edge cases (max {worst})")
    print(f"[kernel K4] edge cases: {ln.numel()} windows of "
          f"{sorted(set(hc.LENGTHS))} cells and N, mismatch and exactly-K "
          f"windows ({int((want < 0).sum())} below 0, "
          f"{int((want == hc.K).sum())} at K): kernel == plain exactly")
    entry = None
    for cell, n_gaps in K4_CELLS.items():
        t0 = time.monotonic()
        aligner, seeded = hc.cell_chunk(cell, os.path.join(tmp, "k4", cell),
                                        2500000001, n_gaps, dev)
        live = [s for s in seeded if s is not None]
        t_buf, q_buf, t_start, q_start, length = pack_windows(live)[:5]
        lut = torch.from_numpy(aligner.hsp_lut.astype(np.int32))
        t, q, ts, qs, ln = on_card(t_buf, q_buf, t_start, q_start, length)
        set_up = time.monotonic() - t0
        perf_reset()
        got = hs.hsp_best(t, q, lut, ts, qs, ln)
        launches = LAUNCHES[K4]
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        want = hs.hsp_best_plain(t, q, lut, ts, qs, ln)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        worst = int((got.long() - want.long()).abs().max())
        check(worst == 0 and launches == 1,
              f"K4 != plain at {cell}'s chunk (max {worst}; {launches} "
              f"launches)")
        ms = cuda_ms(lambda: hs._launch_kernel(t, q, lut, ts, qs, ln), 10)
        cells = int(length.astype(np.int64).sum())
        n_bytes = t_buf.size + q_buf.size + 24 * length.size
        bound = roofline(n_bytes, K4_OPS_PER_CELL * cells)
        reach = int((want >= aligner.hsp_threshold).sum())
        print(f"[kernel K4] {cell}: {len(seeded)} gaps (built and seeded in "
              f"{set_up:.1f} s), {length.size} windows, {cells} cells, "
              f"{t_buf.size} + {q_buf.size} region bytes; {reach} windows "
              f"reach K={aligner.hsp_threshold}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, kernel == plain exactly, {launches} "
              f"launch")
        print(f"[kernel K4] {cell}: bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']} ({K4_OPS_PER_CELL} integer operations a "
              f"cell at {INT32_OPS_PER_S / 1e12:.2f} T/s; {n_bytes} bytes "
              f"would take {1e3 * n_bytes / HBM_BYTES_PER_S:.4f} ms); the "
              f"kernel reaches {100 * bound['bound_ms'] / ms:.1f}% of it; "
              f"library call: none (a segmented max-subarray reduction)")
        t0 = time.monotonic()
        host = [None if s is None else aligner.align_scan(s)
                for s in seeded]
        host_s = time.monotonic() - t0
        perf_reset()
        t0 = time.monotonic()
        rows = aligner.align_scan_batch(seeded)
        batch_s = time.monotonic() - t0
        check(rows == host and LAUNCHES[K4] == 1,
              f"{cell}: the chunk's HSP rows differ from the host scan's "
              f"({LAUNCHES[K4]} K4 launches)")
        print(f"[kernel K4] {cell}: align_scan_batch (one K4 launch, "
              f"{PERF['hsp_windows_device']} windows, "
              f"{PERF['hsp_windows_exact']} split on the host) "
              f"{batch_s:.3f} s, the host scan gap by gap {host_s:.3f} s; "
              f"{sum(len(r) for r in host if r)} HSP rows, every gap's "
              f"equal to the host scan's in order")
        if entry is None:
            entry = {"launches": launches + 1, "max_abs_err": worst,
                     "ms": ms, "plain_ms": plain_ms, **bound,
                     "library_ms": None}
        else:
            entry["launches"] += launches + 1
    return entry


HOST_ENV = {"GAT_RESCORE": "hostnative", "GAT_BAND": "host"}


def host_cli(args: list[str]) -> float:
    """The port's CLI on its all-host paths, in this process: the host-native
    scorer and the host band batch, named by HOST_ENV, which share nothing
    with K1, K2, K3 or the torch scorers.  No -device: those paths resolve
    none.  Must launch no kernel; returns its wall seconds."""
    from genomealignmenttools_tpu_torch.cli.main import main
    from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
    with golden_cases().environ(HOST_ENV):
        perf_reset()
        t0 = time.monotonic()
        rc = main(args)
        secs = time.monotonic() - t0
        counts = dict(LAUNCHES)
    check(rc == 0, f"host-native CLI {args[0]} exited {rc}")
    check(not any(counts.values()),
          f"host-native CLI {args[0]} launched a kernel: {counts}")
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
        check(counts[K3] > 0 and counts[K4] > 0,
              f"{label} never launched {K3} or {K4}")
        if label == "RepeatFiller --refQuirks":
            want = os.path.join(GOLD, "repeatfiller_reference_output.chain")
        else:
            want = o("ref." + name)
            host_cli(argv + [want] + extra)
        check(same_bytes(o(name), want), f"{label}: {o(name)} != {want}")
        print(f"[gap fixtures] {label}: byte-identical to "
              f"{os.path.basename(want)}"
              + ("" if want.startswith(GOLD) else " (the port's host band "
                 "batch, GAT_BAND=host, in process)")
              + f"; {K3} launches {counts[K3]}, {K4} {counts[K4]}; "
              f"{secs:.3f} s")


def phase_repeatfiller(tmp: str, dev, n_gaps: int = 600) -> dict:
    """RepeatFiller at the benchmark's depth (600 gaps); returns K3's
    kernels-line numbers."""
    import torch

    from genomealignmenttools_tpu_torch.device.genome import open_genome
    from genomealignmenttools_tpu_torch.engines.repeat_filler import (
        _gap_job_regions, harvest_gap_jobs)
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_repeatfiller_workload
    from genomealignmenttools_tpu_torch.utils.profiling import (phase_acc_start,
                                                         phase_acc_stop)
    from genomealignmenttools_tpu_torch.ops import band_batch as bb
    from genomealignmenttools_tpu_torch.ops.seed_extend import GapAligner

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
    check(counts[K4] == 1, f"{n_gaps}-gap RepeatFiller launched {K4} "
                           f"{counts[K4]} times, not once (one chunk)")
    peak_cli = torch.cuda.max_memory_allocated()
    host_s = host_cli(args + [host_out])
    check(same_bytes(port_out, host_out),
          f"{n_gaps}-gap RepeatFiller differs from the host-native run")
    band_s = sum(v for k, v in phases.items() if k.startswith("band: "))
    print(f"[repeatfiller] port RepeatFiller {port_s:.3f} s ({K3} launches "
          f"{counts[K3]}, {K4} {counts[K4]}, peak device memory "
          f"{peak_cli / 2**30:.3f} GiB); "
          f"band stage {band_s:.4f} s: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items())
          + f"; the rest (seeds, HSP scan, chaining, splice) "
          f"{port_s - band_s:.3f} s")
    print(f"[repeatfiller] host-native RepeatFiller (the port's host band "
          f"batch, GAT_BAND=host, in process, genomes decoded) "
          f"{host_s:.3f} s; byte-identical to the port's output")

    # the workload's extension problems, as _run_gap_jobs batches them
    scheme = score_scheme_default()
    aligner = GapAligner(
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
    ranges = bb.sub_batches([len(t[1]) for t in todo], batch.max_insert,
                            False, bb.PARENT_BUDGET)
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
    columns = cells = n_moves = 0
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
        work = bb.LAST_WORK[K3].sum(0).tolist()
        columns, cells = columns + work[0], cells + work[1]
        n_moves += int(got[0][:, 4].sum())
        worst = max(worst, *(int((g.to(torch.int64) - p.to(torch.int64))
                                 .abs().max()) for g, p in zip(got, plain)))
        del plain, got
    check(worst == 0, f"K3 != plain at the {n_gaps}-gap shapes (max {worst})")
    print(f"[repeatfiller] K3 at the {n_gaps}-gap shapes: kernel "
          f"{ms['kernel']:.3f} ms, plain {ms['plain']:.3f} ms (summed over "
          f"{len(ranges)} sub-batches); kernel == plain exactly; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # the bound, over the columns these problems ran before their x-drop:
    # a code byte read and half a parent byte written a cell, a code byte and
    # a band centre a column, the moves; K3_OPS_PER_CELL operations a cell
    n_bytes = 1.5 * cells + 5 * columns + n_moves + 48 * len(todo)
    bound = roofline(n_bytes, K3_OPS_PER_CELL * cells)
    print(f"[repeatfiller] K3 bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}: {columns} of {a_cols} columns run, {cells} "
          f"band cells, {K3_OPS_PER_CELL} integer operations a cell at "
          f"{INT32_OPS_PER_S / 1e12:.2f} T/s ({int(n_bytes)} bytes would take "
          f"{1e3 * n_bytes / HBM_BYTES_PER_S:.4f} ms); the kernel reaches "
          f"{100 * bound['bound_ms'] / ms['kernel']:.1f}% of it; library "
          f"call: none (a wandering-band DP with traceback)")
    return {"launches": counts[K3], "k4_launches": counts[K4],
            "max_abs_err": worst, "ms": ms["kernel"],
            "plain_ms": ms["plain"], **bound, "library_ms": None}


def phase_sharded(meta: dict, host: list, dev) -> dict:
    """The chr1 chains through ShardedChainScorer on ["cuda:0"] * k, k = 1,
    2, 4, and on make_mesh() (every visible card), each equal to the
    host-native scores; ShardedBlockScorer on one (t, q, strand) group at
    k = 4 against the single-device K1 sums.  Returns the launches."""
    import numpy as np
    import torch

    from genomealignmenttools_tpu_torch.device.genome import open_genome
    from genomealignmenttools_tpu_torch.formats.chain import read_chains
    from genomealignmenttools_tpu_torch.formats.gapcalc import gap_calc_from_file
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
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
from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
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
    byte-identical to a single-process host-native chainCleaner run in this
    process (GAT_RESCORE=hostnative: the native break loop and prescore).
    Returns the summed launches of the rank processes."""
    import torch

    o = lambda n: os.path.join(tmp, n)  # noqa: E731
    host_s = host_cli([
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
          f"(GAT_RESCORE=hostnative, in process) {host_s:.3f} s")
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


def variant_cases():
    """tests/variant_cases.py: the variant table and its runner; it imports
    only the standard library (and golden_cases) at module level."""
    golden_cases()
    import variant_cases as vc
    return vc


def variants_child(setting: str, lite_dir: str, rf_dir: str,
                   out: str) -> int:
    """python3 chip_smoke.py --variants-child SETTING LITE_DIR RF_DIR OUT:
    the variant rows of one setting (variant_cases.SETTINGS, whose
    environment the caller gives this process) on the card; prints their
    hashes, launches and seconds as one JSON line.  Fails if jax or the JAX
    package was loaded."""
    import torch
    check(torch.cuda.is_available(), "the variants child needs a CUDA card")
    vc = variant_cases()
    payload = vc.run_child(setting, lite_dir, rf_dir, out, "cuda")
    check(not payload["foreign"], f"variants child {setting} loaded jax or "
                                  f"the JAX package: {payload['foreign']}")
    print(json.dumps(payload))
    return 0


def phase_variants(tmp: str) -> dict:
    """Every row of tests/variant_cases.py on the card: the rows of each
    setting that needs a fresh process (GAT_THREADS=1, =8, GAT_NATIVE=0) in
    one child each (--variants-child), side by side, and the others in this
    process meanwhile; each row byte-identical to what it is held to and
    launching what it must, and in the rows of other pair widths and of the
    per-gap band path each launch (the first of the 24-gap row) held to its
    kernel's plain version on the same inputs, at the tile width the row
    sets.  Returns the launches of each kernel and the largest difference
    from the plain version of each kernel held to it."""
    vc = variant_cases()
    root = os.path.join(tmp, "variants")
    lite_dir = os.path.join(tmp, "goldens", "lite")    # built by [goldens]
    rf_dir, out = os.path.join(root, "rf24"), os.path.join(root, "out")
    t0 = time.monotonic()
    lite, rf = vc.workloads(lite_dir, rf_dir)
    print(f"[variants] chr1-lite (from [goldens]) and 24 RepeatFiller gaps "
          f"ready in {time.monotonic() - t0:.3f} s (set-up)")
    table = vc.rows(out, lite, rf)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    children = {}
    for setting, extra in vc.SETTINGS.items():
        if setting != "main":
            children[setting] = (subprocess.Popen(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                 "--variants-child", setting, lite_dir, rf_dir, out],
                env={**env, **extra}, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), time.monotonic())
    results: dict = {}
    with vc.Launches("cuda") as launches:
        for row in table.values():
            if row.setting == "main":
                results[row.id] = vc.run_row(row, out, "cuda", launches)
    child_secs = {}
    for setting, (proc, started) in children.items():
        stdout, stderr = proc.communicate(timeout=600)
        child_secs[setting] = time.monotonic() - started
        lines = stdout.strip().splitlines()
        check(proc.returncode == 0 and bool(lines),
              f"variants child {setting} exited {proc.returncode}: "
              f"{stderr[-3000:]}")
        payload = json.loads(lines[-1])
        check(not payload["foreign"], f"variants child {setting} loaded "
                                      f"{payload['foreign']}")
        want = {r.id for r in table.values() if r.setting == setting}
        check(set(payload["results"]) == want,
              f"variants child {setting} ran {sorted(payload['results'])}")
        results.update(payload["results"])
    total = dict.fromkeys(vc.KERNELS, 0)
    worst: dict = {}
    by_group: dict = {}
    for row in table.values():
        res = results[row.id]
        bad = vc.problem(row, res, results)
        check(bad is None, f"variant {row.id}: {bad}")
        for k in total:
            total[k] += res["launches"][k]
        group = by_group.setdefault(row.group, [0, 0.0])
        group[0] += 1
        group[1] += res["seconds"]
        launched = ", ".join(f"{k} {v}" for k, v in res["launches"].items()
                             if v)
        held = ""
        if row.checked:
            c = res["checks"]
            worst[c["kernel"]] = max(worst.get(c["kernel"], 0),
                                     c["max_abs_err"])
            held = (f"; {c['calls']} launches of {c['kernel']} == plain "
                    f"(max abs err {c['max_abs_err']})" + (
                        f" on tiles of {c['widths'][0]} bytes"
                        if c["widths"] else ""))
        print(f"[variants] {row.id} ({row.mode or 'RepeatFiller'}, "
              f"{row.setting}): {vc.held_to(row)}; launches "
              f"{launched or 'none'}{held}; {res['seconds']:.3f} s")
    print(f"[variants] {len(table)} rows, every one what it is held to with "
          f"the launches it must make; launches {total}; rows and seconds by "
          f"group: " + ", ".join(f"{g} {n} in {secs:.3f} s"
                                 for g, (n, secs) in by_group.items())
          + "; children's wall seconds: " + ", ".join(
              f"{k} {v:.1f}" for k, v in child_secs.items())
          + f"; held to plain, max abs err {worst}")
    return total, worst


def sanitizer_probe() -> subprocess.Popen:
    """compute-sanitizer's memcheck on one CUDA allocation from torch:
    whether it can attach to this card.  Raises where it is not found."""
    from genomealignmenttools_tpu_torch import sanitize
    exe = sanitize.find_compute_sanitizer()
    return subprocess.Popen(
        sanitize.sanitizer_command(exe, "memcheck", [
            sys.executable, "-c",
            "import torch; torch.zeros(1, device='cuda'); "
            "torch.cuda.synchronize()"]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase_sanitize(dev, k3_plain: dict) -> dict:
    """The kernels under the four tools (sanitize.run_cuda): the builtin
    checker always, compute-sanitizer too where it can attach to the card;
    K3's launches held to the plain digests of [kernel K3] (the same
    inputs).  Returns the launches of each kernel entry in the children."""
    from genomealignmenttools_tpu_torch import sanitize
    probe = sanitizer_probe()
    try:
        out = sanitize.run_cuda("builtin", device=str(dev),
                                plain_known=k3_plain)
        text = probe.communicate(timeout=300)[0]
    finally:
        if probe.poll() is None:
            probe.kill()
            probe.wait()
    total = dict(out["launches"])
    if sanitize.REFUSED in text:
        print(f"[sanitize] compute-sanitizer ({sanitize.find_compute_sanitizer()}"
              f"): \"{sanitize.REFUSED}\" on this card (reached through gVisor); "
              f"the kernels' own checks above carry the verdict")
    else:
        check(probe.returncode == 0 and sanitize.parse_summary(text) == 0,
              f"compute-sanitizer's probe failed:\n{text[-3000:]}")
        nv = sanitize.run_cuda("compute-sanitizer", device=str(dev),
                               plain_known=k3_plain)
        for k, v in nv["launches"].items():
            total[k] += v
    print(f"[sanitize] {out['cases']} cases a tool, 0 errors under each of "
          f"memcheck, racecheck, synccheck and initcheck, every launch equal "
          f"to its plain version; launches {total}")
    return total


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
    check(all(counts[k] > 0 for k in (KERNEL, K2, K3)),
          f"the dry run did not launch K1, K2 and K3: {counts}")
    print(f"[dryrun] dryrun_multidevice([cuda:0] * 4): sharded scorers, "
          f"sharded cleaner, chainNet -rescore and RepeatFiller, split band "
          f"DP all exact; launches {counts}; {secs:.3f} s")
    return counts


def clocked(fn, *args):
    """fn(*args), with the phase's wall seconds on a line of their own."""
    t0 = time.monotonic()
    out = fn(*args)
    print(f"[time] {fn.__name__}: {time.monotonic() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.monotonic()
    name, smi = phase_device()
    import torch
    dev = torch.device("cuda", 0)
    clocked(phase_build)
    worst = clocked(phase_kernel, dev)
    worst_k2, worst_formats = clocked(phase_kernel_k2, dev)
    worst_k3, k3_plain = clocked(phase_kernel_k3, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # the phases of earlier slices first, so that their numbers are
        # taken as before: no profiler started, no other process on the card
        k4 = clocked(phase_kernel_k4, tmp, dev)
        format_launches = clocked(phase_fixtures, tmp)
        goldens = clocked(phase_goldens, tmp, dev)
        entry, chr1 = clocked(phase_chr1, tmp, dev)
        resident = clocked(phase_resident, chr1, dev)
        k2_launches, cleaner = clocked(phase_cleaner, tmp)
        clocked(phase_gap_fixtures, tmp)
        rf = clocked(phase_repeatfiller, tmp, dev)
        k1_fc = clocked(phase_filter_chains, tmp)
        sharded = clocked(phase_sharded, chr1, resident.pop("host"), dev)
        dist_launches = clocked(phase_distributed, tmp, cleaner)
        k1_prof = clocked(phase_profile, tmp, chr1)
        variants, variants_err = clocked(phase_variants, tmp)
    sanitized = clocked(phase_sanitize, dev, k3_plain)
    dry = clocked(phase_dryrun, dev)
    entry["max_abs_err"] = max(worst, entry["max_abs_err"])
    entry["launches"] += (k1_fc + k1_prof + sharded[KERNEL]
                          + dist_launches[KERNEL] + dry[KERNEL]
                          + goldens[KERNEL] + variants[KERNEL]
                          + sanitized[KERNEL])
    k2_entry = {"name": K2, "route": "cuda",
                "source": "genomealignmenttools_tpu_torch/csrc/combine.cu",
                "replaces": "genomealignmenttools_tpu/ops/pallas_combine.py:112",
                "launches": (resident["launches"] + k2_launches + sharded[K2]
                             + dist_launches[K2] + dry[K2] + goldens[K2]
                             + variants[K2] + sanitized[K2]),
                "max_abs_err": max(worst_k2, resident["max_abs_err"],
                                   variants_err.get(K2, 0)),
                **{k: resident[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}}
    from genomealignmenttools_tpu_torch.ops.pair_combine import LAUNCH_KEY
    format_entries = []
    for kind, res in resident.pop("formats").items():
        key = LAUNCH_KEY[kind]
        format_entries.append({
            "name": key, "route": "cuda",
            "source": "genomealignmenttools_tpu_torch/csrc/combine.cu",
            "replaces": "genomealignmenttools_tpu/ops/pallas_combine.py:112 "
                        "with the decode of ops/pair_rescore.py:757-759",
            "launches": (res["launches"] + format_launches[key]
                         + goldens[key] + variants[key] + sanitized[key]),
            "max_abs_err": max(worst_formats[kind], res["max_abs_err"],
                               variants_err.get(key, 0)),
            **{k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}})
    k3_entry = {"name": K3, "route": "cuda",
                "source": "genomealignmenttools_tpu_torch/csrc/band.cu",
                "replaces": "genomealignmenttools_tpu/ops/pallas_band.py:63",
                "launches": (rf["launches"] + dry[K3] + goldens[K3]
                             + variants[K3] + sanitized[K3]),
                "max_abs_err": max(worst_k3, rf["max_abs_err"],
                                   variants_err.get(K3, 0)),
                **{k: rf[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
    k4_entry = {"name": K4, "route": "cuda",
                "source": "genomealignmenttools_tpu_torch/csrc/hspscan.cu",
                "replaces": "none: the host scan's filter pass "
                            "(genomealignmenttools_tpu/ops/seed_extend.py "
                            "_scan_windows)",
                "launches": (k4.pop("launches") + rf["k4_launches"]
                             + dry[K4] + sanitized[K4]),
                **k4}
    foreign = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "genomealignmenttools_tpu"
                     or m.startswith("genomealignmenttools_tpu."))
    check(not foreign, f"jax or the JAX package was loaded: {foreign}")
    print("[jax] neither jax nor any module of the JAX package was loaded")
    print(f"[time] whole run: {time.monotonic() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [entry, k2_entry, *format_entries,
                                  k3_entry, k4_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--variants-child"]:
        sys.exit(variants_child(*sys.argv[2:6]))
    sys.exit(main())
