"""The golden cases of the reference's tests that reach a scorer or the band
batch, as argv of the port's CLI (genomealignmenttools_tpu_torch.cli.main),
and the checks of the planted gap cases.

One table serves two runs: tests/test_torch_goldens_rescore.py,
test_torch_goldens_lite.py and test_torch_goldens_gapfill.py hold every case
on the CPU (-device=cpu), the scoring ones in window and pair mode, and
chip_smoke.py's [goldens] phase holds them on the card (-device=cuda), the
scoring ones in window mode and in pair mode in each tile format.  Each case
id names the reference test it mirrors (file-test).

Module level imports only the standard library: chip_smoke.py imports this
file on a machine where nothing of jax may be loaded.  The planted-gap
builders import the port's formats and tests/make_planted.py when called.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
GOLD = os.path.join(HERE, "golden")

# the environment of each scoring mode, as the port's CLI reads it; None
# unsets a name.  The tier-1 twins run "window" and "pair", the card all four
MODES = {
    "window": {"GAT_RESCORE": None, "GAT_COMBINE": None,
               "GAT_PAIR_TILES": None},
    "pair": {"GAT_RESCORE": "pair", "GAT_COMBINE": "device",
             "GAT_PAIR_TILES": None},
    "pair-code": {"GAT_RESCORE": "pair", "GAT_COMBINE": "device",
                  "GAT_PAIR_TILES": "code"},
    "pair-score4": {"GAT_RESCORE": "pair", "GAT_COMBINE": "device",
                    "GAT_PAIR_TILES": "score4"},
}

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


def set_mode(monkeypatch, mode: str, env: dict | None = None) -> None:
    """Set a mode's environment, and `env` on top, for one test."""
    for name, value in {**MODES[mode], **(env or {})}.items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


DEBUG_DUMPS = ("chainsOfInterest.chain", "suspect.chain",
               "brokenChainLfill.chain", "brokenChainRfill.chain",
               "brokenChainfill.chain", "suspectsAndFills.bed")

THRESHOLDS = [
    ("lrfold60", "-LRfoldThreshold=60"),
    ("fold80", "-foldThreshold=80"),
    ("maxsus8000", "-maxSuspectScore=8000"),
    ("minbroken1500k", "-minBrokenChainScore=1500000"),
    ("minlrgap21k", "-minLRGapSize=21000"),
    ("maxbases200", "-maxSuspectBases=200"),
]


def scoring_cases(out: str) -> dict:
    """case id -> (argv, env, [(output, golden)]).

    Every case runs with `out` as its working directory (chainCleaner -debug
    writes its six dumps there, chainCleaner.c:592, 1818-1822).  A golden of
    None means the output must be empty.  `env` is set on top of the mode's
    (None unsets a name)."""
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    g = lambda n: os.path.join(GOLD, n)  # noqa: E731
    o = lambda n: os.path.join(out, n)  # noqa: E731
    sorted_chain = f("synthetic.scored.sorted.chain")
    genomes = [f("target.2bit"), f("query.2bit")]
    nibs = [f("nib/target"), f("nib/query")]
    sizes = ["-tSizes=" + f("target.chrom.sizes"),
             "-qSizes=" + f("query.chrom.sizes")]
    net = "-net=" + f("cleaner_input.net")

    def score(golden, *flags, inputs=genomes, gap="loose"):
        return (["scoreChain", f("synthetic.chain"), *inputs, o("s.out"),
                 "-linearGap=" + gap, *flags], {}, [(o("s.out"), g(golden))])

    def cleaner(chain_golden, bed_golden, *flags, src=sorted_chain,
                inputs=genomes, env=None, extra=()):
        return (["chainCleaner", src, *inputs, o("c.chain"), o("c.bed"),
                 "-linearGap=loose", "-verbose=0", *flags], env or {},
                [(o("c.chain"), chain_golden and g(chain_golden)),
                 (o("c.bed"), bed_golden and g(bed_golden)), *extra])

    cases = {
        # tests/test_score_chain_parity.py:24-46, :49-61, :64-82
        "score_chain_parity-loose": score("scoreChain.loose.chain"),
        "score_chain_parity-medium": score("scoreChain.medium.chain",
                                           gap="medium"),
        "score_chain_parity-hoxd55": score(
            "scoreChain.hoxd55.chain", "-scoreScheme=" + f("HoxD55.q")),
        "score_chain_parity-return_only_score": score(
            "scoreChain.scores.tsv", "-returnOnlyScore"),
        "score_chain_parity-return_only_score_and_coords": score(
            "scoreChain.coords.tsv", "-returnOnlyScoreAndCoords"),
        "score_chain_parity-force_local_score": score(
            "scoreChain.local.chain", "-forceLocalScore"),
        "score_chain_parity-nib_dir_inputs": score(
            "scoreChain.loose.chain", inputs=nibs),
        "score_chain_parity-chain_cleaner_nib_dir_inputs": cleaner(
            "chainCleaner.out.chain", "chainCleaner.removedSuspects.bed",
            *sizes, inputs=nibs),
        # tests/test_chain_cleaner_parity.py:45-99, :126-227
        "chain_cleaner_parity-with_net": cleaner(
            "chainCleaner.out.chain", "chainCleaner.removedSuspects.bed",
            net),
        "chain_cleaner_parity-internal_netting": cleaner(
            "chainCleaner.out.chain", "chainCleaner.removedSuspects.bed",
            *sizes),
        "chain_cleaner_parity-fused_vs_text_breaks": cleaner(
            "chainCleaner.out.chain", "chainCleaner.removedSuspects.bed",
            *sizes, env={"GAT_FUSED_BREAKS": "0"}),
        "chain_cleaner_parity-debug_flag": cleaner(
            "chainCleaner.out.chain", "chainCleaner.removedSuspects.bed",
            net, "-debug",
            extra=[(o(n), g(os.path.join("chainCleaner.debug", n)))
                   for n in DEBUG_DUMPS]),
        "chain_cleaner_parity-suspect_data_file": cleaner(
            "chainCleaner.suspectData.out.chain", None, net,
            "-suspectDataFile=" + o("suspectData.tsv"),
            extra=[(o("suspectData.tsv"),
                    g("chainCleaner.suspectData.tsv"))]),
        "chain_cleaner_parity-only_this": cleaner(
            "chainCleaner.onlyThis.out.chain", "chainCleaner.onlyThis.bed",
            net, "-onlyThisChr=chrA", "-onlyThisStart=382753",
            "-onlyThisEnd=383003"),
        # tests/test_meta_passthrough.py:106-124
        "meta_passthrough-chain_cleaner_meta": cleaner(
            "meta.chainCleaner.chain", "meta.chainCleaner.bed", net,
            src=f("meta.chain")),
        # tests/test_chain_net_parity.py:28-36
        "chain_net_parity-rescore": (
            ["chainNet", sorted_chain, f("target.chrom.sizes"),
             f("query.chrom.sizes"), o("t.net"), o("q.net"), "-rescore",
             "-tNibDir=" + f("target.2bit"), "-qNibDir=" + f("query.2bit"),
             "-linearGap=loose"], {},
            [(o("t.net"), g("chainNetRescore.target.net")),
             (o("q.net"), g("chainNetRescore.query.net"))]),
        # tests/test_drivers.py:35-50
        "drivers-filter_chains_pipeline_parity": (
            ["FilterChainsNetFilterNets", sorted_chain,
             f("cleaner_input.net"), o("fc.chain"), o("fc.net"), *genomes,
             f("target.chrom.sizes"), f("query.chrom.sizes"),
             "-minScore=50000,200000", "-minSizeT=1000,0",
             "-minSizeQ=1000,0"], {},
            [(o("fc.chain"), g("filterChains.filtered.chain")),
             (o("fc.net"), g("filterChains.filtered.net"))]),
    }
    # tests/test_chain_cleaner_thresholds.py
    for tag, flag in THRESHOLDS:
        cases[f"chain_cleaner_thresholds-{tag}"] = cleaner(
            f"thresholds/cc.{tag}.chain", f"thresholds/cc.{tag}.bed", net,
            flag)
    # tests/test_chain_cleaner_pairs.py: both modes, and the python break
    # loop (the oracle) on the pair decision
    p = lambda n: os.path.join(FIX, "pairs", n)  # noqa: E731
    for tag, flags, env in (("nopairs", [], None),
                            ("pairs", ["-doPairs"], None),
                            ("pairs_python_oracle", ["-doPairs"],
                             {"GAT_BREAK_LOOP": "0"})):
        gold = "pairs" if tag.startswith("pairs") else "nopairs"
        cases[f"chain_cleaner_pairs-{tag}"] = cleaner(
            f"pairs/chainCleaner.{gold}.out.chain",
            f"pairs/chainCleaner.{gold}.bed", "-net=" + p("pairs.input.net"),
            *flags, src=p("pairs.scored.sorted.chain"),
            inputs=[p("target.2bit"), p("query.2bit")], env=env)
    return cases


# which (case, mode) an older test of the port already holds against the
# golden on the CPU; the tier-1 twin runs every other pair, the card all
HELD_ELSEWHERE = {
    ("score_chain_parity-loose", "window"):
        "test_torch_cli.py::test_port_cli_matches_goldens_and_jax_cli",
    ("score_chain_parity-loose", "pair"):
        "test_torch_cli.py::test_port_cli_pair_mode_matches_goldens",
    ("chain_cleaner_parity-with_net", "window"):
        "test_torch_cli.py::test_port_cli_matches_goldens_and_jax_cli",
    ("chain_cleaner_parity-with_net", "pair"):
        "test_torch_cli.py::test_port_cli_pair_mode_matches_goldens",
    ("chain_cleaner_parity-internal_netting", "window"):
        "test_torch_cli.py::test_port_cli_matches_goldens_and_jax_cli",
    ("chain_cleaner_parity-internal_netting", "pair"):
        "test_torch_cli.py::test_port_cli_pair_mode_matches_goldens",
    ("chain_net_parity-rescore", "window"):
        "test_torch_cli.py::test_port_cli_matches_goldens_and_jax_cli",
    ("chain_net_parity-rescore", "pair"):
        "test_torch_cli.py::test_port_cli_pair_mode_matches_goldens",
    ("drivers-filter_chains_pipeline_parity", "window"):
        "test_torch_cli.py::test_filter_chains_net_filter_nets_cli",
}
for _tag, _ in THRESHOLDS:
    HELD_ELSEWHERE[(f"chain_cleaner_thresholds-{_tag}", "window")] = \
        "test_torch_cli.py::test_chain_cleaner_threshold_flags_match_goldens"
    HELD_ELSEWHERE[(f"chain_cleaner_thresholds-{_tag}", "pair")] = \
        "test_torch_cli.py::test_chain_cleaner_threshold_flags_pair_mode"
for _tag in ("nopairs", "pairs"):
    HELD_ELSEWHERE[(f"chain_cleaner_pairs-{_tag}", "window")] = \
        "test_torch_cli.py::test_chain_cleaner_do_pairs_matches_goldens"


def first_difference(path: str, golden: str | None) -> str | None:
    """None when the file at `path` equals the golden byte for byte (an
    empty file where the golden is None); else where they first differ."""
    with open(path, "rb") as fh:
        got = fh.read()
    want = b""
    if golden is not None:
        with open(golden, "rb") as fh:
            want = fh.read()
    if got == want:
        return None
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    line = got[:n].count(b"\n") + 1
    return (f"{path} differs from {golden or 'an empty file'} at byte {n} "
            f"(line {line}): {got[n:n + 60]!r} against {want[n:n + 60]!r}")


def perturbed_input(path: str) -> str:
    """tests/test_chain_cleaner_parity.py:168-212: the sorted fixture with
    7919 added to every stored score, so that stored != recomputed; written
    to `path`, whose text is returned."""
    with open(os.path.join(FIX, "synthetic.scored.sorted.chain")) as fh:
        src = fh.read()
    out = []
    for line in src.splitlines(keepends=True):
        if line.startswith("chain "):
            parts = line.split(" ")
            parts[1] = str(int(parts[1]) + 7919)
            line = " ".join(parts)
        out.append(line)
    text = "".join(out)
    with open(path, "w") as fh:
        fh.write(text)
    return text


def zero_removal_argv(in_chain: str, out: str) -> list[str]:
    """chainCleaner on the perturbed input with a fold threshold nothing
    passes: zero removals, the full-cover score side effect still applied."""
    f = lambda n: os.path.join(FIX, n)  # noqa: E731
    return ["chainCleaner", in_chain, f("target.2bit"), f("query.2bit"),
            os.path.join(out, "c.chain"), os.path.join(out, "c.bed"),
            "-net=" + f("cleaner_input.net"),
            "-tSizes=" + f("target.chrom.sizes"),
            "-qSizes=" + f("query.chrom.sizes"), "-linearGap=loose",
            "-foldThreshold=1e18", "-verbose=0"]


# --- chr1-lite (tests/test_chr1_scale.py:49-115) -----------------------------

LITE_SCENARIOS, LITE_BULK = 200, 3000


def lite_hashes() -> dict:
    with open(os.path.join(GOLD, "chr1_lite.json")) as fh:
        return json.load(fh)


def sha256(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def lite_cases(m: dict, out: str) -> dict:
    """case id -> (argv, [(output, key of chr1_lite.json)]) on the workload
    `m` of build_cleaner_workload(n_scenarios=200, n_bulk=3000)."""
    o = lambda n: os.path.join(out, n)  # noqa: E731
    return {
        "chr1_scale-chaincleaner_chr1_lite_parity": (
            ["chainCleaner", m["chain"], m["t2bit"], m["q2bit"],
             o("lite.chain"), o("lite.bed"), "-tSizes=" + m["t_sizes"],
             "-qSizes=" + m["q_sizes"], "-linearGap=loose", "-verbose=0"],
            [(o("lite.chain"), "c_out.chain.sha256"),
             (o("lite.bed"), "c_out.bed.sha256")]),
        "chr1_scale-chainnet_rescore_chr1_lite_parity": (
            ["chainNet", m["chain"], m["t_sizes"], m["q_sizes"],
             o("lite.t.net"), o("lite.q.net"), "-rescore",
             "-tNibDir=" + m["t2bit"], "-qNibDir=" + m["q2bit"],
             "-linearGap=loose"],
            [(o("lite.t.net"), "c_rescore.t.net.sha256"),
             (o("lite.q.net"), "c_rescore.q.net.sha256")]),
    }


def port_cli_at_1_and_8_threads(args_at, tmp_path, env: dict) -> dict:
    """{threads: [bytes of each output]} of the port's CLI (-device=cpu) run
    at GAT_THREADS=1 and =8 under `env`, each in a fresh interpreter
    (GAT_THREADS is read once per process) in tmp_path/t<n> with one torch
    thread; the two processes run side by side.  args_at(d) gives (argv,
    names of the outputs in d)."""
    import subprocess
    import sys
    procs, names = {}, {}
    for n in (1, 8):
        d = tmp_path / f"t{n}"
        d.mkdir()
        args, names[n] = args_at(d)
        procs[n] = subprocess.Popen(
            [sys.executable, "-m", "genomealignmenttools_tpu_torch.cli.main",
             *args, "-device=cpu"],
            env={**env, "GAT_THREADS": str(n), "OMP_NUM_THREADS": "1"},
            cwd=str(d), text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
    outs = {}
    for n, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        outs[n] = [(tmp_path / f"t{n}" / name).read_bytes()
                   for name in names[n]]
    return outs


# --- planted gaps through RepeatFiller (tests/test_planted_alignment.py) -----

def planted_cases() -> list:
    with open(os.path.join(GOLD, "planted_cases.json")) as fh:
        return json.load(fh)


def planted_case(name: str) -> dict:
    return next(c for c in planted_cases() if c["spec"]["name"] == name)


def merge_abutting(blocks) -> list:
    """Collapse zero-gap neighbours so trivially equivalent decompositions
    compare equal (test_planted_alignment.py:46-55)."""
    out = []
    for b in blocks:
        if out and out[-1][1] == b[0] and out[-1][3] == b[2]:
            out[-1][1], out[-1][3] = b[1], b[3]
        else:
            out.append([int(b[0]), int(b[1]), int(b[2]), int(b[3])])
    return out


def on_target(blocks, planted) -> list:
    """The blocks that overlap any planted block on the target."""
    return [b for b in blocks
            if any(b[0] < pb[1] and b[1] > pb[0] for pb in planted)]


def build_planted(name: str):
    """(t, q, built blocks) of a planted case, its digests checked against
    the golden (test_planted_alignment.py:63-68)."""
    import numpy as np

    from make_planted import build_case
    case = planted_case(name)
    t, q, built = build_case(case["spec"])

    def digest(arr):
        return int(np.int64(arr.astype(np.int64)
                            @ (np.arange(arr.shape[0]) % 251 + 1)))
    if (digest(t), digest(q)) != (case["t_digest"], case["q_digest"]) \
            or built.tolist() != case["planted_blocks"]:
        raise ValueError(f"planted case {name} does not rebuild the golden's "
                         f"sequences and blocks")
    return t, q, built


def planted_gap_inputs(name: str, tmp: str):
    """One chain whose gap spans a planted case (test_planted_alignment.py
    :171-186), written as t.2bit, q.2bit and in.chain under `tmp` by the
    port's formats: (chain, t2bit, q2bit, planted blocks)."""
    import numpy as np

    from genomealignmenttools_tpu_torch.formats.chain import (Chain,
                                                              write_chains)
    from genomealignmenttools_tpu_torch.formats.twobit import write_twobit
    t, q, built = build_planted(name)
    tn, qn = t.shape[0], q.shape[0]
    a0t, a0q = 500, 500
    a1t, a1q = tn - 700, qn - 700
    q[a0q:a0q + 120] = t[a0t:a0t + 120]
    q[a1q:a1q + 120] = t[a1t:a1t + 120]
    blocks = np.array([[a0t, a0t + 120, a0q, a0q + 120],
                       [a1t, a1t + 120, a1q, a1q + 120]], np.int64)
    chain = Chain(score=100000, t_name="chrT", t_size=tn, t_start=a0t,
                  t_end=a1t + 120, q_name="chrQ", q_size=qn, q_strand="+",
                  q_start=a0q, q_end=a1q + 120, id=1, blocks=blocks)
    bases = np.frombuffer(b"TCAGN", dtype=np.uint8)  # code order T,C,A,G,N
    os.makedirs(tmp, exist_ok=True)
    t2, q2 = os.path.join(tmp, "t.2bit"), os.path.join(tmp, "q.2bit")
    write_twobit(t2, [("chrT", bases[t].tobytes())])
    write_twobit(q2, [("chrQ", bases[q].tobytes())])
    cf = os.path.join(tmp, "in.chain")
    with open(cf, "w") as fh:
        write_chains([chain], fh)
    return cf, t2, q2, built.tolist()


# the three end-to-end gap cases, each checked against construction truth
PLANTED_GAPS = {
    "planted_alignment-planted_end_to_end_repeatfiller":
        "small_indels_high_identity",
    "planted_alignment-transposed_gap_end_to_end_keeps_colinear_best":
        "transposed_pieces",
    "planted_alignment-inverted_gap_end_to_end_leaves_gap_unfilled":
        "inverted_copy_invisible",
}


def planted_gap_problem(case_id: str, in_chain: str, out_text: str,
                        planted: list) -> str | None:
    """None when RepeatFiller's output `out_text` on a planted gap is what
    its reference test demands, else what is wrong."""
    import io

    import numpy as np

    from genomealignmenttools_tpu_torch.formats.chain import read_chains
    name = PLANTED_GAPS[case_id]
    if name == "inverted_copy_invisible":
        with open(in_chain) as fh:
            want = fh.read().rstrip("\n")
        return (None if out_text.rstrip("\n") == want
                else "the inverted gap was filled")
    b = read_chains(io.StringIO(out_text))[0].blocks
    if name == "small_indels_high_identity":
        planted = merge_abutting(planted)
        inside = b[(b[:, 0] >= planted[0][0] - 50)
                   & (b[:, 1] <= planted[-1][1] + 50)]
        got = merge_abutting(inside.tolist())
        return None if got == planted else f"spliced {got}, planted {planted}"
    best = max(planted, key=lambda p: p[1] - p[0])
    other = min(planted, key=lambda p: p[1] - p[0])
    inside = b[(b[:, 0] >= best[0] - 50) & (b[:, 1] <= best[1] + 50)]
    got = merge_abutting(inside.tolist())
    if got != [best]:
        return f"spliced {got}, the colinear best piece is {best}"
    overlap = b[(b[:, 0] < other[1]) & (b[:, 1] > other[0])]
    return (None if np.asarray(overlap).shape[0] == 0
            else f"spliced the transposed piece: {overlap.tolist()}")


def planted_recovery_problem(spec_name: str, planted_blocks: list,
                             got: list) -> str | None:
    """test_planted_alignment.py:58-93 on the aligner's blocks `got`: the
    planted decomposition recovered exactly, off-target material at most
    15% of the planted bases (except for the paralog decoy)."""
    planted = merge_abutting(planted_blocks)
    got4 = merge_abutting(sorted([b[:4] for b in got]))
    hit = on_target(got4, planted)
    if hit != planted:
        return f"on target {hit}, planted {planted}"
    if spec_name == "paralog_decoy":
        return None
    planted_bases = sum(b[1] - b[0] for b in planted)
    extra = sum(b[1] - b[0] for b in got4 if b not in hit)
    return (None if extra <= 0.15 * planted_bases
            else f"{extra} off-target bases against {planted_bases} planted")
