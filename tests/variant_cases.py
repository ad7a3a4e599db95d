"""The variants of the port's scoring and gap-filling paths that an
environment variable or an entry point picks, beyond the four scoring modes
of golden_cases.MODES: thread counts, the CLI's sharded chainCleaner, the
engines' scorer seams, pair tiles at other widths, no native library, the
combine choice (and its int32 overflow fallback) and RepeatFiller's per-gap
band path and python HSP scan.

One table serves two runs: tests/test_torch_variants.py holds every row on
the CPU (-device=cpu) that no older test of the port holds (a row's `twin`
names the test that does), and chip_smoke.py's [variants] phase holds every
row on the card (-device=cuda).  Each row gives the call (the port's CLI or
an engine or scorer entry point), its environment (a mode of
golden_cases.MODES and names on top), what its outputs are held to (goldens,
C hashes of tests/golden/chr1_lite.json, another row's bytes, or the
host-native scores) and the kernel launches it must make; the rows of
other pair widths and of the per-gap band path also hold each launch of
their kernel to its plain version on the same inputs (`checked`).

Rows whose setting is not "main" run in a fresh interpreter with the
setting's environment, one per setting (`run_child`): the native library
reads GAT_THREADS once per process (native/gat_threads.h) and GAT_NATIVE
when it is first loaded (native/__init__.py).

Module level imports only the standard library: chip_smoke.py imports this
file on a machine where nothing of jax may be loaded.  The runners import
the port when called.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import NamedTuple

import golden_cases as gc

FIX, GOLD = gc.FIX, gc.GOLD

# the environment of each process a row may run in; "main" is the caller's
# own process
SETTINGS = {"main": {}, "threads1": {"GAT_THREADS": "1"},
            "threads8": {"GAT_THREADS": "8"}, "native0": {"GAT_NATIVE": "0"}}

K1, K3 = "rescore_chunks", "band_ext"
# the LAUNCHES key of K2's row source in each pair mode of golden_cases.MODES
# (ops/pair_combine.py LAUNCH_KEY of the GAT_PAIR_TILES format)
K2_OF = {"pair": "pair_combine", "pair-code": "pair_combine_code",
         "pair-score4": "pair_combine_score4"}
KERNELS = (K1, *K2_OF.values(), K3)
PAIR_MODES = tuple(K2_OF)
PAIR_CHUNKS = ("2", "6", "130", "258")
# RepeatFiller's gaps that give the band DP work, one K3 launch each under
# GAT_RF_BATCH=0: 2 of the 14 gaps of tests/fixtures/repeatfiller_input.chain
# and every gap of build_repeatfiller_workload(n_gaps=24)
RF_GAPS_WITH_WORK = {"fixtures": 2, "rf24": 24}
# the launches of the 24-gap per-gap row held to K3's plain version, whose
# column loop of small torch ops is slow (about 1.5 s a gap on a CPU)
RF24_HELD_TO_PLAIN = 1

# the CPU twins of the rows that older tests hold
_LITE = "test_torch_goldens_lite.py::"
_RESCORE = "test_torch_goldens_rescore.py::"
_GAPFILL = "test_torch_goldens_gapfill.py::"
_PAIR = "test_torch_pair_rescore.py::"
NEW_TWIN = "test_torch_variants.py::test_variant_row_on_cpu"


class Row(NamedTuple):
    id: str
    group: str         # threads, shards, seams, widths, native, combine, band
    setting: str       # key of SETTINGS
    mode: str | None   # key of golden_cases.MODES; None: RepeatFiller
    env: dict          # on top of the mode's (None unsets a name)
    call: tuple        # (kind, argument): see run_row
    outputs: list      # the files whose bytes are held
    held: tuple        # ("golden", [paths]) | ("hash", [chr1_lite keys])
    #                    | ("row", id) | ("host-native", None)
    launches: dict     # kernel -> exact count or "+" (one or more); every
    #                    kernel not named must not launch
    twin: str          # the CPU test that holds the row
    checked: tuple = ()  # (kernel, tile width in bytes or None, launches
    #                      or None for all): each launch of the kernel in
    #                      the row is held to its plain version on the
    #                      same inputs (KernelCheck)


def _scoring_launches(mode: str) -> dict:
    """K1 in window mode, the format's K2 row source in a pair mode: every
    pair row runs the device combine through score_chains (no row takes
    scoreChain's score_table, which launches neither)."""
    return {K1: "+"} if mode == "window" else {K2_OF[mode]: "+"}


def _lite_argv(tool: str, m: dict, o) -> tuple[list, list]:
    """(argv, outputs) of chr1-lite chainCleaner or chainNet -rescore, as
    golden_cases.lite_cases gives them."""
    case = {"chainCleaner": "chr1_scale-chaincleaner_chr1_lite_parity",
            "chainNet": "chr1_scale-chainnet_rescore_chr1_lite_parity"}[tool]
    return gc.lite_cases(m, o(""))[case]


# the case of golden_cases.scoring_cases that runs each rescoring tool on
# the fixtures with its plain flags
FIXTURE_CASE = {"scoreChain": "score_chain_parity-loose",
                "chainNet": "chain_net_parity-rescore",
                "chainCleaner": "chain_cleaner_parity-internal_netting"}


def _fixture_argv(tool: str, o) -> tuple[list, list]:
    """(argv, [(output, golden)]) of a rescoring tool on the fixtures."""
    argv, _, outputs = gc.scoring_cases(o(""))[FIXTURE_CASE[tool]]
    return argv, outputs


PLACEHOLDER = {k: "" for k in ("chain", "t2bit", "q2bit", "t_sizes",
                               "q_sizes")}


def rows(out: str, lite: dict | None = None, rf: dict | None = None
         ) -> dict:
    """row id -> Row, every output under out/<row id>/.  `lite` is
    build_cleaner_workload(n_scenarios=200, n_bulk=3000) and `rf`
    build_repeatfiller_workload(n_gaps=24) (workloads() builds both); left
    out, the ids and every field but the paths are still right."""
    lite = lite or PLACEHOLDER
    rf = rf or PLACEHOLDER
    table: dict = {}

    def add(rid, group, setting, mode, env, call, outputs, held, launches,
            twin=NEW_TWIN, checked=()):
        table[rid] = Row(rid, group, setting, mode, env, call, outputs, held,
                         launches, twin, checked)

    def rf24(rid):
        return ("cli", ["RepeatFiller", "-c", rf["chain"], "-T2", rf["t2bit"],
                        "-Q2", rf["q2bit"], "-o", at(rid)("rf.chain")])

    def at(rid):
        return lambda n: os.path.join(out, rid, n)

    # the base of the 24-gap rows: the port's host band batch, which shares
    # nothing with K3 or its plain version (band_batch._run_host)
    base = "host-RepeatFiller-rf24"
    add(base, "band", "main", None, {"GAT_BAND": "host"}, rf24(base),
        [at(base)("rf.chain")],
        ("base", "the host band batch (GAT_BAND=host)"), {})
    # threads: chr1-lite in window and int8 pair mode against the C hashes,
    # RepeatFiller on 24 gaps against the host band batch, at 1 and 8
    # threads
    for n in (1, 8):
        setting = f"threads{n}"
        for tool in ("chainCleaner", "chainNet"):
            for mode in ("window", "pair"):
                rid = f"threads{n}-{tool}-lite-{mode}"
                argv, outputs = _lite_argv(tool, lite, at(rid))
                twin = NEW_TWIN
                if mode == "window":
                    twin = _LITE + ("test_chaincleaner_thread_determinism"
                                    if tool == "chainCleaner" else
                                    "test_chainnet_rescore_thread_determinism")
                add(rid, "threads", setting, mode, {}, ("cli", argv),
                    [p for p, _ in outputs],
                    ("hash", [k for _, k in outputs]),
                    _scoring_launches(mode), twin)
        rid = f"threads{n}-RepeatFiller-rf24"
        add(rid, "threads", setting, None, {}, rf24(rid),
            [at(rid)("rf.chain")], ("row", base), {K3: "+"},
            "test_torch_goldens_repeatfiller_threads.py::"
            "test_repeatfiller_thread_determinism")
    cc = [os.path.join(GOLD, n) for n in ("chainCleaner.out.chain",
                                          "chainCleaner.removedSuspects.bed")]
    net = [os.path.join(GOLD, f"chainNetRescore.{n}.net")
           for n in ("target", "query")]
    for mode in gc.MODES:
        old = mode in ("window", "pair")
        # shards: -numShards 2 and 3 with -shard/-shardOut, then -mergeShards
        for n in (2, 3):
            rid = f"shards{n}-chainCleaner-{mode}"
            add(rid, "shards", "main", mode, {}, ("shards", n),
                [at(rid)("c.chain"), at(rid)("c.bed")], ("golden", cc),
                _scoring_launches(mode),
                _RESCORE + "test_chain_cleaner_sharded_merge_parity"
                if old else NEW_TWIN)
        # seams: the engines with the port's scorer as scorer_factory
        rid = f"seam-clean_chains-{mode}"
        add(rid, "seams", "main", mode, {}, ("clean_chains", None),
            [at(rid)("c.chain"), at(rid)("c.bed")], ("golden", cc),
            _scoring_launches(mode),
            _RESCORE + "test_chain_cleaner_batched_device_path"
            if old else NEW_TWIN)
        rid = f"seam-chain_net-{mode}"
        add(rid, "seams", "main", mode, {}, ("chain_net", None),
            [at(rid)("t.net"), at(rid)("q.net")], ("golden", net),
            _scoring_launches(mode),
            _RESCORE + "test_chain_net_rescore_batched_device"
            if old else NEW_TWIN)
    # widths: GAT_PAIR_CHUNK through the CLI in every pair format (4-bit
    # rows of 1, 3, 65 and 129 bytes), every K2 launch held to its plain
    # version on the tiles it scored, whose width is checked
    for mode in PAIR_MODES:
        for chunk in PAIR_CHUNKS:
            width = int(chunk) // 2 if mode == "pair-score4" else int(chunk)
            for tool in ("chainNet", "chainCleaner"):
                rid = f"width{chunk}-{tool}-{mode}"
                argv, outputs = _fixture_argv(tool, at(rid))
                add(rid, "widths", "main", mode, {"GAT_PAIR_CHUNK": chunk},
                    ("cli", argv), [p for p, _ in outputs],
                    ("golden", [g for _, g in outputs]),
                    _scoring_launches(mode), checked=(K2_OF[mode], width,
                                                      None))
    # no native library: the numpy combine per chain, the numpy packers;
    # scoreChain's score_table declines, so it scores through score_chains
    # and launches what the other tools launch
    for mode in ("window", "pair"):
        for tool in ("scoreChain", "chainNet", "chainCleaner"):
            rid = f"native0-{tool}-{mode}"
            argv, outputs = _fixture_argv(tool, at(rid))
            add(rid, "native", "native0", mode, {}, ("cli", argv),
                [p for p, _ in outputs], ("golden", [g for _, g in outputs]),
                _scoring_launches(mode))
    # the combine choice on a TorchChainScorer: auto takes the host combine
    # on a chain set's first call and K2 on the repeat; host never takes K2;
    # the global scores also those of scoreChain's golden
    for mode in PAIR_MODES:
        for combine in ("auto", "host"):
            rid = f"combine_{combine}-scorer-{mode}"
            add(rid, "combine", "main", mode, {"GAT_COMBINE": combine},
                ("combine", combine), [],
                ("host-native", os.path.join(GOLD, "scoreChain.loose.chain")),
                {K2_OF[mode]: 1} if combine == "auto" else {},
                _PAIR + "test_score_chains_combine_choice"
                if mode == "pair" else NEW_TWIN)
    rid = "combine_overflow-scorer-pair"
    add(rid, "combine", "main", "pair", {"GAT_COMBINE": "device"},
        ("overflow", at(rid)("huge.gap")), [], ("host-native", None), {},
        _PAIR + "test_overflow_takes_host_combine")
    # RepeatFiller's sequential per-gap path and python HSP scan beside the
    # batched run, each held to the golden of the reference CLI; each of the
    # per-gap path's launches held to K3's plain version
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    batched = _GAPFILL + "test_repeat_filler_batched_band_path_matches_" \
                         "sequential"
    for tag, env, launches, twin, checked in (
            ("batched", {}, {K3: "+"}, batched, ()),
            ("per_gap", {"GAT_RF_BATCH": "0"},
             {K3: RF_GAPS_WITH_WORK["fixtures"]}, NEW_TWIN, (K3, None, None)),
            ("hsp_python", {"GAT_HSP_NATIVE": "0"}, {K3: "+"},
             _GAPFILL + "test_repeat_filler_native_hsp_scan_matches_numpy",
             ())):
        rid = f"band-RepeatFiller-{tag}"
        add(rid, "band", "main", None, env,
            ("cli", ["RepeatFiller", "-c", f("repeatfiller_input.chain"),
                     "-T2", f("target.2bit"), "-Q2", f("query.2bit"), "-o",
                     at(rid)("rf.chain"), "--refQuirks"]),
            [at(rid)("rf.chain")],
            ("golden", [os.path.join(
                GOLD, "repeatfiller_reference_output.chain")]),
            launches, twin, checked)
    rid = "band-RepeatFiller-per_gap-rf24"
    add(rid, "band", "main", None, {"GAT_RF_BATCH": "0"}, rf24(rid),
        [at(rid)("rf.chain")], ("row", base),
        {K3: RF_GAPS_WITH_WORK["rf24"]}, batched,
        (K3, None, RF24_HELD_TO_PLAIN))
    return table


def workloads(lite_dir: str, rf_dir: str) -> tuple[dict, dict]:
    """(lite, rf): the chr1-lite and 24-gap RepeatFiller workloads, built
    into the two directories or read from them where built before."""
    from genomealignmenttools_tpu_torch.utils.bench_workload import (
        build_cleaner_workload, build_repeatfiller_workload)
    return (build_cleaner_workload(lite_dir, n_scenarios=gc.LITE_SCENARIOS,
                                   n_bulk=gc.LITE_BULK),
            build_repeatfiller_workload(rf_dir, n_gaps=24))


# --- running a row ------------------------------------------------------------

class Launches:
    """The kernel launches of a run.  On the card, the port's LAUNCHES.  On
    the CPU, where each wrapper runs its plain version and counts nothing,
    the calls of the three wrappers the engines reach (window_rescore.
    chunk_sums, pair_rescore's pair_combine_scan_tiles, band_batch.
    band_ext_batch): on CUDA tensors each call is one launch."""

    def __init__(self, device: str):
        from genomealignmenttools_tpu_torch.device import LAUNCHES
        self.cuda = device != "cpu"
        self.counts = LAUNCHES if self.cuda else dict.fromkeys(KERNELS, 0)
        self._undo: list = []

    def __enter__(self):
        if self.cuda:
            return self
        from genomealignmenttools_tpu_torch.ops import (band_batch,
                                                        pair_combine,
                                                        pair_rescore,
                                                        window_rescore)

        def spy(module, name, key_of):
            real = getattr(module, name)

            def counted(*args, **kw):
                self.counts[key_of(*args, **kw)] += 1
                return real(*args, **kw)
            setattr(module, name, counted)
            self._undo.append((module, name, real))

        spy(window_rescore, "chunk_sums", lambda *a, **k: K1)
        spy(band_batch, "band_ext_batch", lambda *a, **k: K3)
        spy(pair_rescore, "pair_combine_scan_tiles",
            lambda tiles, bias, flags, tweak=None, kind="score8", table=None:
            pair_combine.LAUNCH_KEY[kind])
        return self

    def __exit__(self, *exc):
        for module, name, real in reversed(self._undo):
            setattr(module, name, real)
        self._undo.clear()

    def snap(self) -> dict:
        return {k: self.counts[k] for k in KERNELS}


class KernelCheck:
    """Holds the launches of one kernel in a run (the first `limit`, or
    all) to the kernel's plain version on the same inputs, each right after
    its launch, and notes the width of the tiles K2 scored.  It wraps the
    call sites the engines reach (pair_rescore's pair_combine_scan_tiles,
    band_batch.band_ext_batch); the plain versions count no launch.  On the
    CPU, where the wrapper runs the plain version, the comparison is exact
    by construction, but the widths are still those scored."""

    def __init__(self, kernel: str, limit: int | None = None):
        self.kernel, self.limit = kernel, limit
        self.calls, self.widths, self.max_abs_err = 0, set(), 0
        self.shapes_equal = True

    def __enter__(self):
        from genomealignmenttools_tpu_torch.ops import (band_batch,
                                                        pair_combine,
                                                        pair_rescore)
        if self.kernel == K3:
            module, name, plain = (band_batch, "band_ext_batch",
                                   band_batch.band_ext_plain)
        else:
            module, name, plain = (pair_rescore, "pair_combine_scan_tiles",
                                   pair_combine.pair_combine_scan_tiles_plain)
        real = getattr(module, name)

        def held(*args, **kw):
            got = real(*args, **kw)
            if self.limit is None or self.calls < self.limit:
                self.calls += 1
                if self.kernel != K3:
                    self.widths.add(int(args[0].shape[1]))
                self._compare(got, plain(*args, **kw))
            return got
        setattr(module, name, held)
        self._undo = (module, name, real)
        return self

    def _compare(self, got, want) -> None:
        import torch
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                self.shapes_equal = False
            elif g.numel():
                d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                self.max_abs_err = max(self.max_abs_err, d)

    def __exit__(self, *exc):
        setattr(*self._undo)

    def result(self) -> dict:
        return {"kernel": self.kernel, "calls": self.calls,
                "widths": sorted(self.widths),
                "shapes_equal": self.shapes_equal,
                "max_abs_err": self.max_abs_err}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in KERNELS}


def _sync(device: str) -> None:
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def _cli(argv: list, device: str) -> None:
    from genomealignmenttools_tpu_torch.cli.main import main
    rc = main(argv + [f"-device={device}"])
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")


def _scorer_inputs(gap=None):
    """(scheme, gap calc, target, query genome) of the fixtures, the
    port's loose gap calc unless `gap` names a file."""
    from genomealignmenttools_tpu_torch.device.genome import Genome
    from genomealignmenttools_tpu_torch.formats.gapcalc import \
        gap_calc_from_file
    from genomealignmenttools_tpu_torch.formats.scorematrix import \
        score_scheme_default
    return (score_scheme_default(), gap_calc_from_file(gap or "loose"),
            Genome(os.path.join(FIX, "target.2bit")),
            Genome(os.path.join(FIX, "query.2bit")))


def random_chains(seed: int = 11, n: int = 40) -> list:
    """tests/test_torch_rescore.py's _random_chains in the port's Chain:
    negative runs, multi-chunk blocks, both strands, on the fixtures'
    chrA and chrQ1."""
    import numpy as np

    from genomealignmenttools_tpu_torch.formats.chain import Chain
    rng = np.random.default_rng(seed)
    chains = []
    for ci in range(n):
        nb = int(rng.integers(1, 12))
        t = int(rng.integers(0, 800_000))
        q = int(rng.integers(0, 1_700_000))
        blocks = []
        for _ in range(nb):
            ln = int(rng.integers(1, 600))
            blocks.append((t, t + ln, q, q + ln))
            t += ln + int(rng.integers(0, 3000))
            q += ln + int(rng.integers(0, 3000))
        b = np.array(blocks, np.int64)
        chains.append(Chain(
            score=0.0, t_name="chrA", t_size=1_000_000,
            t_start=int(b[0, 0]), t_end=int(b[-1, 1]), q_name="chrQ1",
            q_size=2_000_000, q_strand="+" if ci % 2 else "-",
            q_start=int(b[0, 2]), q_end=int(b[-1, 3]), id=ci + 1, blocks=b))
    return chains


def write_huge_gap_calc(path: str) -> str:
    """tests/test_torch_pair_rescore.py's _huge_gap_calc: the loose table
    with every cost times 10^6, so that a chain with a few gaps passes
    2^31, the reach of the device combine's int32 scans."""
    pos = "1 2 3 11 111 2111 12111 32111 72111 152111 252111"
    loose = {"qGap": [325, 360, 400, 450, 600, 1100, 3600, 7600, 15600,
                      31600, 56600],
             "bothGap": [625, 660, 700, 750, 900, 1400, 4000, 8000, 16000,
                         32000, 57000]}
    lines = [f"{k} " + " ".join(str(v * 1000000) for v in loose[src])
             for k, src in (("qGap", "qGap"), ("tGap", "qGap"),
                            ("bothGap", "bothGap"))]
    with open(path, "w") as fh:
        fh.write("tableSize 11\nsmallSize 111\nposition " + pos + "\n"
                 + "\n".join(lines) + "\n")
    return path


def _combine_choice(combine: str, mode: str, device: str,
                    launches: Launches) -> None:
    """One TorchChainScorer in pair mode scores the fixtures' chains twice:
    under auto the first call takes the host combine (no K2) and the repeat
    K2 once; under host neither call launches.  Both equal the host-native
    scores, whose global scores are those of scoreChain's golden."""
    from genomealignmenttools_tpu_torch.formats.chain import read_chains
    from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
    inputs = _scorer_inputs()
    chains = read_chains(os.path.join(FIX, "synthetic.chain"))
    want = TorchChainScorer(*inputs, mode="hostnative").score_chains(chains)
    golden = read_chains(os.path.join(GOLD, "scoreChain.loose.chain"))
    if [g for g, _, _ in want] != [c.score for c in golden]:
        raise AssertionError("the host-native global scores differ from "
                             "scoreChain.loose.chain's")
    scorer = TorchChainScorer(*inputs, device=device)
    key = K2_OF[mode]
    for call, expect in enumerate((0, 1 if combine == "auto" else 0)):
        before = launches.snap()
        got = scorer.score_chains(chains)
        _sync(device)
        n = _delta(before, launches.snap())[key]
        if got != want:
            raise AssertionError(f"GAT_COMBINE={combine} call {call + 1}: "
                                 f"scores differ from the host-native ones")
        if n != expect:
            raise AssertionError(f"GAT_COMBINE={combine} call {call + 1} "
                                 f"launched {key} {n} times, not {expect}")
    if not scorer._repeat_workload:
        raise AssertionError("the second call was not a repeat workload")


def _overflow(gap_path: str, device: str) -> None:
    """The device combine on chains whose scores pass 2^31: the int32
    guard sends the batch to the host combine, PERF["combine_overflow"]
    goes up by one, and the scores equal the host-native ones."""
    from genomealignmenttools_tpu_torch.device import PERF
    from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
    os.makedirs(os.path.dirname(gap_path), exist_ok=True)
    inputs = _scorer_inputs(write_huge_gap_calc(gap_path))
    chains = random_chains()
    want = TorchChainScorer(*inputs, mode="hostnative").score_chains(chains)
    before = PERF["combine_overflow"]
    got = TorchChainScorer(*inputs, device=device).score_chains(chains)
    if PERF["combine_overflow"] != before + 1:
        raise AssertionError("the int32 guard did not take the host combine")
    if got != want or max(-g for g, _, _ in want) < 2 ** 31:
        raise AssertionError("overflow scores differ from the host-native "
                             "ones, or no chain passes 2^31")


def _shards(n: int, o, device: str) -> None:
    """chainCleaner -numShards=n -shard=s -shardOut for every s, then
    -mergeShards into o("c.chain") and o("c.bed")."""
    argv, _ = _fixture_argv("chainCleaner", o)
    paths = []
    for s in range(n):
        paths.append(o(f"shard{s}.json"))
        _cli(argv[:4] + [o("unused.chain"), o("unused.bed")] + argv[6:]
             + [f"-numShards={n}", f"-shard={s}", "-shardOut=" + paths[-1]],
             device)
    from genomealignmenttools_tpu_torch.cli.main import main
    if main(["chainCleaner", "-mergeShards=" + ",".join(paths), o("c.chain"),
             o("c.bed")]) != 0:
        raise RuntimeError("chainCleaner -mergeShards failed")


def _seam(kind: str, o, device: str) -> None:
    """clean_chains or chain_net(rescore=True) with the port's scorer on
    `device` as scorer_factory (the reference tests' DeviceChainScorer)."""
    from genomealignmenttools_tpu_torch.ops.rescore import \
        torch_scorer_factory
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    factory = torch_scorer_factory(device)
    if kind == "clean_chains":
        from genomealignmenttools_tpu_torch.engines.chain_cleaner import \
            clean_chains
        clean_chains(f("synthetic.scored.sorted.chain"), f("target.2bit"),
                     f("query.2bit"), o("c.chain"), o("c.bed"),
                     t_sizes=f("target.chrom.sizes"),
                     q_sizes=f("query.chrom.sizes"), linear_gap="loose",
                     scorer_factory=factory)
        return
    from genomealignmenttools_tpu_torch.engines.chain_net import chain_net
    with open(o("t.net"), "w") as t_out, open(o("q.net"), "w") as q_out:
        chain_net(f("synthetic.scored.sorted.chain"),
                  f("target.chrom.sizes"), f("query.chrom.sizes"), t_out,
                  q_out, rescore=True, t_2bit=f("target.2bit"),
                  q_2bit=f("query.2bit"), linear_gap="loose",
                  scorer_factory=factory)


def run_row(row: Row, out: str, device: str, launches: Launches) -> dict:
    """Run one row on `device` ("cpu", or "cuda" on the card) inside
    `launches`, its mode's environment and its own set for the call.
    Returns {"sha256": [one per output], "launches": {kernel: count},
    "seconds": wall seconds, "checks": KernelCheck's result or None}.  A
    scorer row checks its scores itself and raises on any difference."""
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    o = lambda n: os.path.join(out, row.id, n)  # noqa: E731
    os.makedirs(o(""), exist_ok=True)
    env = {**(gc.MODES[row.mode] if row.mode else {}), **row.env}
    kind, arg = row.call
    set_verbosity(0)
    check = None
    if row.checked:
        kernel, _, limit = row.checked
        check = KernelCheck(kernel, limit)
    with gc.environ(env), check or contextlib.nullcontext():
        before = launches.snap()
        t0 = time.monotonic()
        if kind == "cli":
            _cli(arg, device)
        elif kind == "shards":
            _shards(arg, o, device)
        elif kind in ("clean_chains", "chain_net"):
            _seam(kind, o, device)
        elif kind == "combine":
            _combine_choice(arg, row.mode, device, launches)
        elif kind == "overflow":
            _overflow(arg, device)
        else:
            raise ValueError(f"unknown call {kind!r}")
        _sync(device)
        secs = time.monotonic() - t0
        counts = _delta(before, launches.snap())
    return {"sha256": [gc.sha256(p) for p in row.outputs],
            "launches": counts, "seconds": secs,
            "checks": check.result() if check else None}


def held_to(row: Row) -> str:
    """What a row's outputs are held to, in words."""
    what, arg = row.held
    if what == "golden":
        return "byte-identical to " + ", ".join(os.path.basename(p)
                                                for p in arg)
    if what == "hash":
        return "the C hashes " + ", ".join(arg)
    if what == "row":
        return f"byte-identical to {arg}"
    if what == "base":
        return f"nothing: {arg}, the base of the rows held to it"
    return "the host-native scores" + (
        f" and {os.path.basename(arg)}'s global scores" if arg else "")


def problem(row: Row, result: dict, results: dict) -> str | None:
    """None when a row's result is what it is held to and it launched what
    it must; else what is wrong.  `results` holds every row's result by id
    (a row held to another row's bytes reads that row's there)."""
    what, arg = row.held
    got = result["sha256"]
    if what == "golden":
        want = [gc.sha256(p) for p in arg]
    elif what == "hash":
        hashes = gc.lite_hashes()
        want = [hashes[k] for k in arg]
    elif what == "row":
        want = results[arg]["sha256"]
    else:
        want = got          # a base, or a scorer row that checked itself
    if got != want:
        bad = [os.path.basename(p) for p, a, b in zip(row.outputs, got, want)
               if a != b]
        return f"{', '.join(bad)} not {held_to(row)}"
    for k in KERNELS:
        n, expect = result["launches"][k], row.launches.get(k, 0)
        if (n < 1) if expect == "+" else (n != expect):
            return (f"launched {k} {n} times, expected "
                    f"{'one or more' if expect == '+' else expect}: "
                    f"{result['launches']}")
    if row.checked:
        kernel, width, _ = row.checked
        held = result["checks"]
        if held["calls"] < 1:
            return f"no launch of {kernel} was held to its plain version"
        if not held["shapes_equal"] or held["max_abs_err"]:
            return (f"{kernel} != its plain version: shapes equal "
                    f"{held['shapes_equal']}, max abs err "
                    f"{held['max_abs_err']}")
        if width is not None and held["widths"] != [width]:
            return (f"{kernel} scored tiles of {held['widths']} bytes, not "
                    f"{width}")
    return None


def foreign_modules() -> list:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "genomealignmenttools_tpu"
                  or m.startswith("genomealignmenttools_tpu."))


def run_child(setting: str, lite_dir: str, rf_dir: str, out: str,
              device: str, ids: list | None = None) -> dict:
    """The rows of `setting` (or those of `ids`), in this process, which
    must have been started with SETTINGS[setting] in its environment; empty
    workload directories serve rows that need no workload.  Returns
    {"results": {id: run_row's result}, "foreign": foreign_modules() after
    the runs}; chip_smoke.py --variants-child prints it as one JSON line."""
    for name, value in SETTINGS[setting].items():
        if os.environ.get(name) != value:
            raise RuntimeError(f"setting {setting} needs {name}={value} in "
                               f"the environment of a fresh process")
    lite, rf = workloads(lite_dir, rf_dir) if lite_dir else (None, None)
    table = rows(out, lite, rf)
    results = {}
    with Launches(device) as launches:
        for row in table.values():
            if row.setting == setting and (ids is None or row.id in ids):
                results[row.id] = run_row(row, out, device, launches)
    return {"results": results, "foreign": foreign_modules()}
