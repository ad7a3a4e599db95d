"""Port twins of the reference's golden tests of the tools that score
nothing: the kent chain, net, axt, maf, psl and lav tools, the '#' meta
pass-through, dupnet, chainNet without -rescore, chainBridge, axtChain,
ExtractSynInvChainsFromNet and the reference's example data.

Each case runs the reference test's inputs through the port's CLI
(genomealignmenttools_tpu_torch.cli.main, with -device=cpu, which these
commands accept and ignore) and compares every output with the same golden
byte for byte.  One parametrised test per tool family; each case id names
the reference test it mirrors (file-test).  A case is a list of steps and a
list of (output, golden).  A step is an argv and the file its stdout goes to
(None: not captured), or a function and the path of the input it writes.
An output may be a directory, compared file by file.  The axtChain and
example-data twins read their inputs where the reference's tests find them
(test_axt_chain_parity._ref_dir, test_example_parity.EX) and skip where
those skip, with the same reasons.

Not twinned here: kent_tools-chain_swap (tests/test_torch_cli.py holds the
chainSwap golden through the port's CLI).
"""

import contextlib
import io
import os

import pytest

import golden_cases as gc
from genomealignmenttools_tpu_torch.cli.main import main as port_main
# where kent's axtChain test inputs and the example data are, and whether
# they are there, is the reference tests' own decision
from test_axt_chain_parity import _ref_dir as _axt_chain_dir
from test_example_parity import EX

FIX, GOLD = gc.FIX, gc.GOLD
f = lambda n: os.path.join(FIX, n)  # noqa: E731
g = lambda n: os.path.join(GOLD, n)  # noqa: E731
S = f("synthetic.scored.sorted.chain")
T2, Q2 = f("target.2bit"), f("query.2bit")
TSZ, QSZ = f("target.chrom.sizes"), f("query.chrom.sizes")
NET = g("chainNet.target.net")
AXT = g("chainToAxt.axt")
MAF, PMAF = g("axtToMaf.maf"), g("axtToMaf.prefixed.maf")


def run_case(steps, outputs, ignore=()):
    for argv, stdout in steps:
        if callable(argv):      # a step that writes an input file
            argv(stdout)
            continue
        if stdout is None:
            assert port_main(argv + ["-device=cpu"]) == 0, argv
            continue
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert port_main(argv + ["-device=cpu"]) == 0, argv
        with open(stdout, "w") as fh:
            fh.write(buf.getvalue())
    for got, golden in outputs:
        if os.path.isdir(str(golden)):
            names = sorted(n for n in os.listdir(golden) if n not in ignore)
            assert sorted(os.listdir(got)) == names
            for name in names:
                assert gc.first_difference(os.path.join(got, name),
                                           os.path.join(golden, name)) \
                    is None, name
        else:
            assert gc.first_difference(got, golden) is None


def one(argv, golden, out, stdout=False):
    """One step whose single output (a file, or its stdout) is `golden`."""
    if stdout:
        return [(argv, out)], [(out, golden)]
    return [(argv + [out], None)], [(out, golden)]


# --- chain tools: tests/test_kent_tools_parity.py, test_converters_parity.py,
# test_chain_bridge.py -------------------------------------------------------

def write_merge_list(path):
    with open(path, "w") as fh:
        fh.write("\n".join(f(f"mergepart{i}.chain") for i in range(3)) + "\n")


def chain_cases(o):
    merge = [f(f"mergepart{i}.chain") for i in range(3)]
    return {
        "kent_tools-chain_pre_net": one(
            ["chainPreNet", S, TSZ, QSZ], g("chainPreNet.chain"), o("out")),
        "kent_tools-chain_pre_net_dots": (
            [(["chainPreNet", S, TSZ, QSZ, o("out"), "-dots=3"],
              o("stdout"))],
            [(o("out"), g("chainPreNet.chain")),
             (o("stdout"), g("chainPreNet.dots.txt"))]),
        "kent_tools-chain_to_axt": one(
            ["chainToAxt", S, T2, Q2], g("chainToAxt.axt"), o("out")),
        "kent_tools-chain_to_axt_min_id_min_score": one(
            ["chainToAxt", S, T2, Q2, "-minId=60", "-minScore=1000"],
            g("chainToAxt.minid.axt"), o("out")),
        "kent_tools-chain_to_axt_bed": one(
            ["chainToAxt", S, T2, Q2, "-bed"], g("chainToAxt.bed"), o("out")),
        "kent_tools-chain_anti_repeat": one(
            ["chainAntiRepeat", T2, Q2, S], g("chainAntiRepeat.chain"),
            o("out")),
        "kent_tools-chain_filter-minScore": one(
            ["chainFilter", S, "-minScore=100000"],
            g("chainFilter.minScore.chain"), o("out"), stdout=True),
        "kent_tools-chain_filter-tStrand": one(
            ["chainFilter", S, "-t=chrA", "-strand=-"],
            g("chainFilter.tStrand.chain"), o("out"), stdout=True),
        "kent_tools-chain_filter-zeroGap": one(
            ["chainFilter", S, "-zeroGap", "-long"],
            g("chainFilter.zeroGap.chain"), o("out"), stdout=True),
        "kent_tools-chain_stitch_id": one(
            ["chainStitchId", f("fragments.chain")],
            g("chainStitchId.chain"), o("out")),
        "kent_tools-chain_merge_sort": one(
            ["chainMergeSort", *merge], g("chainMergeSort.chain"), o("out"),
            stdout=True),
        "kent_tools-chain_merge_sort_input_list": (
            [(write_merge_list, o("list.txt")),
             (["chainMergeSort", "-inputList=" + o("list.txt")], o("out"))],
            [(o("out"), g("chainMergeSort.chain"))]),
        "kent_tools-chain_split": (
            [(["chainSplit", o("split"), S], None)],
            [(o("split"), g("chainSplit"))]),
        "kent_tools-chain_sort_tie_order": one(
            ["chainSort", f("ties.chain")], g("chainSort.ties.chain"),
            o("out")),
        "kent_tools-chain_sort_index": (
            [(["chainSort", f("synthetic.chain"), o("s.chain"),
               "-index=" + o("score.idx")], None)],
            [(o("score.idx"), g("chainSort.score.idx"))]),
        "converters-chain_to_psl_basic": one(
            ["chainToPslBasic", S], g("chainToPslBasic.psl"), o("out")),
        "converters-chain_to_psl": one(
            ["chainToPsl", S, TSZ, QSZ, T2, Q2], g("chainToPsl.psl"),
            o("out")),
        "converters-chain_overlap": one(
            ["chainOverlap", S], g("chainOverlap.chain"), o("out"),
            stdout=True),
        "chain_bridge-chain_bridge_parity": one(
            ["chainBridge", S, T2, Q2], g("chainBridge.chain"), o("out")),
    }


# --- net tools: tests/test_kent_tools_parity.py, test_chain_net_parity.py,
# test_chain_cleaner_parity.py, test_drivers.py -------------------------------

def net_cases(o):
    cases = {
        "kent_tools-net_syntenic": one(
            ["netSyntenic", NET], g("netSyntenic.net"), o("out")),
        "kent_tools-net_filter_syn": one(
            ["netFilter", g("netSyntenic.net"), "-syn"],
            g("netFilter.syn.net"), o("out"), stdout=True),
        "kent_tools-net_filter_min_score": one(
            ["netFilter", NET, "-minScore=20000"], g("netFilter.minScore.net"),
            o("out"), stdout=True),
        "kent_tools-net_to_bed-simple": one(
            ["netToBed", NET], g("netToBed.simple.bed"), o("out")),
        "kent_tools-net_to_bed-detailed": one(
            ["netToBed", NET, "-maxGap=1000", "-minFill=100"],
            g("netToBed.detailed.bed"), o("out")),
        "kent_tools-net_split": (
            [(["netSplit", NET, o("split")], None)],
            [(o("split"), g("netSplit"))]),
        "kent_tools-net_to_axt": one(
            ["netToAxt", NET, S, T2, Q2], g("netToAxt.axt"), o("out")),
        "kent_tools-net_to_axt_gap_out": (
            [(["netToAxt", NET, S, T2, Q2, o("out.axt"),
               "-gapOut=" + o("gap.tab")], None)],
            [(o("gap.tab"), g("netToAxt.gap.tab"))]),
        "chain_net_parity-plain": (
            [(["chainNet", S, TSZ, QSZ, o("t.net"), o("q.net")], None)],
            [(o("t.net"), g("chainNet.target.net")),
             (o("q.net"), g("chainNet.query.net"))]),
        "chain_cleaner_parity-net_filter_non_nested_pipeline": (
            [(["chainNet", S, TSZ, QSZ, o("t.net"), os.devnull,
               "-minScore=0"], None),
             (["NetFilterNonNested", o("t.net"), "-minScore1", "3000"],
              o("out"))],
            [(o("out"), f("cleaner_input.net"))]),
        "drivers-extract_syn_inv_parity": one(
            ["ExtractSynInvChainsFromNet", f("netSyntenic.classed.net"), S,
             "-keepSynNetsWithScore", "5000", "-keepInvNetsWithScore",
             "5000"], g("extractSynInv.chain"), o("out")),
        "drivers-extract_syn_inv_type_at_eol_quirk": (
            [(["ExtractSynInvChainsFromNet", g("netSyntenic.net"),
               f("synthetic.chain"), o("out"), "-keepSynNetsWithScore",
               "5000", "-keepInvNetsWithScore", "5000"], None)],
            [(o("out"), None)]),
    }
    for flags, name in [
            (["-line", "-minScore=50000"], "netFilter.line.net"),
            (["-line", "-gap", "-minGap=100"], "netFilter.gapline.net"),
            (["-tStartMin=100000", "-tEndMax=900000"], "netFilter.coord.net"),
            (["-qOverlapStart=200000", "-qOverlapEnd=700000"],
             "netFilter.overlap.net")]:
        cases[f"kent_tools-net_filter_line_and_coord_modes-{name[10:-4]}"] = \
            one(["netFilter", NET, *flags], g(name), o("out"), stdout=True)
    for tag, flag in [("minspace400", "-minSpace=400"),
                      ("minfill600", "-minFill=600"),
                      ("minscore90k", "-minScore=90000")]:
        cases[f"chain_net_parity-flag_variants_byte_parity-{tag}"] = (
            [(["chainNet", S, TSZ, QSZ, o("t.net"), o("q.net"), flag], None)],
            [(o("t.net"), g(f"thresholds/net.{tag}.tnet")),
             (o("q.net"), g(f"thresholds/net.{tag}.qnet"))])
    return cases


# --- axt, maf, psl: tests/test_converters_parity.py -------------------------

def axt_maf_psl_cases(o):
    return {
        "converters-axt_to_psl": one(
            ["axtToPsl", AXT, TSZ, QSZ], g("axtToPsl.psl"), o("out")),
        "converters-axt_sort": one(
            ["axtSort", AXT], g("axtSort.axt"), o("out")),
        "converters-axt_swap": one(
            ["axtSwap", AXT, TSZ, QSZ], g("axtSwap.axt"), o("out")),
        "converters-axt_to_maf": one(
            ["axtToMaf", AXT, TSZ, QSZ], MAF, o("out")),
        "converters-axt_to_maf-prefixed": one(
            ["axtToMaf", AXT, TSZ, QSZ, "-tPrefix=hg.", "-qPrefix=mm."],
            PMAF, o("out")),
        "converters-axt_to_maf_tsplit": (
            [(["axtToMaf", f("sorted.axt"), TSZ, QSZ, o("split"),
               "-qPrefix=q.", "-tSplit"], None)],
            [(o("split"), g("axtToMaf.tsplit"))]),
        "converters-maf_to_axt": one(
            ["mafToAxt", MAF, "first", "chrQ"], g("mafToAxt.axt"), o("out")),
        "converters-maf_to_psl": one(
            ["mafToPsl", "mm", "hg", PMAF], g("mafToPsl.psl"), o("out")),
        "converters-maf_to_fa": one(
            ["mafToFa", MAF], g("mafToFa.fa"), o("out")),
        "converters-maf_ranges": one(
            ["mafRanges", PMAF, "hg"], g("mafRanges.bed"), o("out")),
        "converters-maf_ranges-mindgaps": one(
            ["mafRanges", PMAF, "hg", "-otherDb=mm", "-notAllOGap"],
            g("mafRanges.mindgaps.bed"), o("out")),
        "converters-maf_no_align": one(
            ["mafNoAlign", PMAF], g("mafNoAlign.bed"), o("out")),
        "converters-psl_mrna_cover": (
            [(["pslMrnaCover", f("mrna.psl"), f("mrna.fa"),
               "-listZero=" + o("zero.tab")], o("out"))],
            [(o("out"), g("pslMrnaCover.txt")),
             (o("zero.tab"), g("pslMrnaCover.zero.tab"))]),
        "converters-psl_mrna_cover-minSize500": one(
            ["pslMrnaCover", f("mrna.psl"), f("mrna.fa"), "-minSize=500"],
            g("pslMrnaCover.minSize500.txt"), o("out"), stdout=True),
    }


# --- lav: tests/test_lav_parity.py ------------------------------------------

def lav_cases(o):
    lav, self_lav = f("synthetic.lav"), f("self.lav")
    return {
        "lav-lav_to_psl": one(["lavToPsl", lav], g("lavToPsl.psl"), o("out")),
        "lav-lav_to_psl_bed": one(["lavToPsl", lav, "-bed"],
                                  g("lavToPsl.bed"), o("out")),
        "lav-lav_to_psl_target_strand_and_scores": (
            [(["lavToPsl", lav, o("out"), "-target-strand=+",
               "-scoreFile=" + o("scores.txt")], None)],
            [(o("out"), g("lavToPsl.tstrand.psl")),
             (o("scores.txt"), g("lavToPsl.scores.txt"))]),
        "lav-lav_to_axt_2bit": one(["lavToAxt", lav, T2, Q2],
                                   g("lavToAxt.axt"), o("out")),
        "lav-lav_to_axt_nib": one(
            ["lavToAxt", lav, f("nib/target"), f("nib/query")],
            g("lavToAxt.nib.axt"), o("out")),
        "lav-lav_to_axt_fasta": (
            [(["lavToAxt", lav, T2, f("query.fa"), o("out"), "-fa"], None)],
            [(o("out"), g("lavToAxt.fa.axt"))]),
        "lav-lav_to_axt_drop_self": (
            [(["lavToAxt", self_lav, T2, T2, o("out"), "-dropSelf"], None)],
            [(o("out"), g("lavToAxt.dropSelf.axt"))]),
        "lav-lav_to_axt_drop_self_score_scheme": (
            [(["lavToAxt", self_lav, T2, T2, o("out"), "-dropSelf",
               "-scoreScheme=" + f("HoxD55.q")], None)],
            [(o("out"), g("lavToAxt.dropSelf.hoxd55.axt"))]),
    }


# --- '#' meta pass-through: tests/test_meta_passthrough.py (chainCleaner's
# case scores and is in tests/golden_cases.py) --------------------

def meta_cases(o):
    meta = f("meta.chain")
    return {
        "meta_passthrough-chain_sort_meta": one(
            ["chainSort", meta], g("meta.chainSort.chain"), o("out")),
        "meta_passthrough-chain_pre_net_meta": one(
            ["chainPreNet", meta, TSZ, QSZ], g("meta.chainPreNet.chain"),
            o("out")),
        "meta_passthrough-chain_anti_repeat_meta": one(
            ["chainAntiRepeat", T2, Q2, meta],
            g("meta.chainAntiRepeat.chain"), o("out")),
        "meta_passthrough-chain_merge_sort_meta": one(
            ["chainMergeSort", f("meta.mergeA.chain"), f("meta.mergeB.chain")],
            g("meta.chainMergeSort.chain"), o("out"), stdout=True),
        "meta_passthrough-chain_split_meta": (
            [(["chainSplit", o("split"), meta], None)],
            [(o("split"), g("meta.chainSplit"))]),
        "meta_passthrough-net_syntenic_meta": one(
            ["netSyntenic", f("meta.net")], g("meta.netSyntenic.net"),
            o("out")),
        "meta_passthrough-net_to_axt_meta": one(
            ["netToAxt", f("meta.net"), S, T2, Q2], g("meta.netToAxt.axt"),
            o("out")),
        "meta_passthrough-axt_to_maf_meta": one(
            ["axtToMaf", f("meta.axt"), TSZ, QSZ], g("meta.axtToMaf.maf"),
            o("out")),
    }


# --- dupnet: tests/test_dupnet_parity.py ------------------------------------

def dupnet_cases(o):
    d = lambda n: os.path.join(FIX, "dupnet", n)  # noqa: E731
    gd = lambda n: os.path.join(GOLD, "dupnet", n)  # noqa: E731
    return {
        "dupnet_parity-chain_net_dup_heavy_parity": (
            [(["chainNet", d("dupnet.scored.sorted.chain"),
               d("target.chrom.sizes"), d("query.chrom.sizes"), o("t.net"),
               o("q.net")], None)],
            [(o("t.net"), gd("chainNet.tnet")),
             (o("q.net"), gd("chainNet.qnet"))]),
        "dupnet_parity-net_syntenic_dup_heavy_parity": one(
            ["netSyntenic", gd("chainNet.tnet")], gd("netSyntenic.net"),
            o("out")),
        "dupnet_parity-netfilter_ucsc_syn_mode_parity": one(
            ["NetFilterNonNested", gd("netSyntenic.net"),
             "-doUCSCSynFilter"], gd("NetFilterNonNested.ucsc.net"),
            o("out"), stdout=True),
        "dupnet_parity-netfilter_score_keepsyn_mode_parity": one(
            ["NetFilterNonNested", gd("netSyntenic.net"), "-doScoreFilter",
             "-minScore1", "60000", "-keepSynNetsWithScore", "8000",
             "-keepInvNetsWithScore", "8000"],
            gd("NetFilterNonNested.score.net"), o("out"), stdout=True),
    }


def _ids(builder):
    return list(builder(lambda n: n))


def _params(builder):
    return pytest.mark.parametrize("case", _ids(builder))


def _run(builder, tmp_path, case, ignore=()):
    o = lambda n: str(tmp_path / n)  # noqa: E731
    steps, outputs = builder(o)[case]
    run_case(steps, outputs, ignore)


@_params(chain_cases)
def test_chain_tools_golden(tmp_path, case):
    _run(chain_cases, tmp_path, case)


@_params(net_cases)
def test_net_tools_golden(tmp_path, case):
    # the netSplit golden holds the C tool's own meta.tmp scratch file
    _run(net_cases, tmp_path, case, ignore=("meta.tmp",))


@_params(axt_maf_psl_cases)
def test_axt_maf_psl_golden(tmp_path, case):
    _run(axt_maf_psl_cases, tmp_path, case)


@_params(lav_cases)
def test_lav_golden(tmp_path, case):
    _run(lav_cases, tmp_path, case)


@_params(meta_cases)
def test_meta_passthrough_golden(tmp_path, case):
    _run(meta_cases, tmp_path, case)


@_params(dupnet_cases)
def test_dupnet_golden(tmp_path, case):
    _run(dupnet_cases, tmp_path, case)
    if case == "dupnet_parity-net_syntenic_dup_heavy_parity":
        text = (tmp_path / "out").read_text()
        for tag in ("qDup", "qOver", "qFar", "inv"):  # the fixture's point
            assert tag in text, tag


# --- axtChain: tests/test_axt_chain_parity.py --------------------------------

def _derive_fa_nib(ref, tmp_path):
    """Fasta and nib copies of kent's 2bit inputs, written by the port's
    formats (test_axt_chain_parity.py:84-106)."""
    from genomealignmenttools_tpu_torch.formats.nib import write_nib
    from genomealignmenttools_tpu_torch.formats.twobit import TwoBitFile
    paths = {}
    for role, fname in (("t", "hg19.chrM.2bit"), ("q", "susScr3.chrM.2bit")):
        tbf = TwoBitFile(os.path.join(ref, "input", fname))
        nib_dir = tmp_path / f"nib_{role}"
        nib_dir.mkdir()
        with open(tmp_path / f"{role}.fa", "w") as fa:
            for name in tbf.seq_names():
                chars = tbf.read_seq(name).chars()
                fa.write(f">{name}\n")
                for i in range(0, len(chars), 50):
                    fa.write(chars[i:i + 50].decode() + "\n")
                write_nib(str(nib_dir / f"{name}.nib"), chars)
        paths[role + "_fa"] = str(tmp_path / f"{role}.fa")
        paths[role + "_nib"] = str(nib_dir)
    return paths


@pytest.mark.parametrize("case", [
    "axt_chain_parity-psl_mode-newStyleLastz",
    "axt_chain_parity-psl_mode-oldStyleBlastz",
    "axt_chain_parity-psl_fasta_mode-newStyleLastz",
    "axt_chain_parity-psl_fasta_mode-oldStyleBlastz",
    "axt_chain_parity-psl_nibdir_mode-newStyleLastz",
    "axt_chain_parity-psl_nibdir_mode-oldStyleBlastz",
    "axt_chain_parity-details_mode"])
def test_axt_chain_golden(tmp_path, case):
    ref = _axt_chain_dir()
    kind, name = (case.split("-") + ["newStyleLastz"])[1:3]
    inp = lambda n: os.path.join(ref, "input", n)  # noqa: E731
    t, q, flags = inp("hg19.chrM.2bit"), inp("susScr3.chrM.2bit"), []
    if kind == "psl_fasta_mode":
        p = _derive_fa_nib(ref, tmp_path)
        t, q, flags = p["t_fa"], p["q_fa"], ["-faT", "-faQ"]
    elif kind == "psl_nibdir_mode":
        p = _derive_fa_nib(ref, tmp_path)
        t, q = p["t_nib"], p["q_nib"]
    out = str(tmp_path / "out.chain")
    argv = ["axtChain", "-psl", "-linearGap=loose", "-minScore=3000",
            "-scoreScheme=" + inp(f"{name}.Q.txt"), *flags,
            inp(f"{name}.psl"), t, q, out]
    if kind == "details_mode":
        argv.append("-details=" + str(tmp_path / "details.txt"))
        run_case([(argv, None)], [(str(tmp_path / "details.txt"),
                                   g("axtChain.details.txt"))])
    else:
        run_case([(argv, None)], [(out, os.path.join(
            ref, "expected", f"{name}.chain"))])


# --- the reference's example data: tests/test_example_parity.py -------------

EX_CHAIN = os.path.join(EX, "hg38.danRer10.chain")
EX_TSZ = os.path.join(EX, "hg38.chrom.sizes")
EX_QSZ = os.path.join(EX, "danRer10.chrom.sizes")


def example_cases(o):
    ge = lambda n: os.path.join(GOLD, "example", n)  # noqa: E731
    srt = ge("chainSort.chain")
    return {
        "example_parity-chain_sort": one(
            ["chainSort", EX_CHAIN], srt, o("out")),
        "example_parity-chain_pre_net": one(
            ["chainPreNet", srt, EX_TSZ, EX_QSZ], ge("chainPreNet.chain"),
            o("out")),
        "example_parity-chain_net": (
            [(["chainNet", srt, EX_TSZ, EX_QSZ, o("t.net"), o("q.net"),
               "-minSpace=1"], None)],
            [(o("t.net"), ge("chainNet.tnet")),
             (o("q.net"), ge("chainNet.qnet"))]),
        "example_parity-net_syntenic": one(
            ["netSyntenic", ge("chainNet.tnet")], ge("netSyntenic.net"),
            o("out")),
        "example_parity-net_to_bed": one(
            ["netToBed", ge("chainNet.tnet")], ge("netToBed.bed"), o("out")),
        "example_parity-net_filter": one(
            ["netFilter", ge("chainNet.tnet"), "-minScore=5000"],
            ge("netFilter.minScore.net"), o("out"), stdout=True),
        "example_parity-chain_filter": one(
            ["chainFilter", srt, "-minScore=10000"],
            ge("chainFilter.minScore.chain"), o("out"), stdout=True),
        "example_parity-chain_stitch_id": one(
            ["chainStitchId", srt], ge("chainStitchId.chain"), o("out")),
        "example_parity-chain_swap": one(
            ["chainSwap", srt], ge("chainSwap.chain"), o("out")),
        "example_parity-chain_to_psl_basic": one(
            ["chainToPslBasic", srt], ge("chainToPslBasic.psl"), o("out")),
        "example_parity-chain_overlap": one(
            ["chainOverlap", srt], ge("chainOverlap.chain"), o("out"),
            stdout=True),
        "example_parity-net_filter_non_nested": one(
            ["NetFilterNonNested", ge("netSyntenic.net"), "-doScoreFilter",
             "-minScore1", "5000", "-keepSynNetsWithScore", "5000",
             "-keepInvNetsWithScore", "5000"], ge("NetFilterNonNested.net"),
            o("out"), stdout=True),
    }


@pytest.mark.skipif(not os.path.isdir(EX),
                    reason="reference example data not mounted")
@_params(example_cases)
def test_example_golden(tmp_path, case):
    _run(example_cases, tmp_path, case)


# --- every golden is named by a port test ------------------------------------

# the one golden no test of the port holds: the bench's own baseline
# (bench.py is not ported)
NOT_HELD = {"bench_baseline.json"}


def test_every_golden_is_named_by_a_port_test():
    """Each entry of tests/golden/ (a file, or a directory of them) is named
    in a tests/test_torch_*.py file or in the twins' case table
    tests/golden_cases.py.  A name found is read as a port test comparing
    with that golden; the name's use is not checked here."""
    texts = []
    for name in sorted(os.listdir(gc.HERE)):
        if (name.startswith("test_torch_") and name.endswith(".py")) \
                or name == "golden_cases.py":
            with open(os.path.join(gc.HERE, name)) as fh:
                texts.append(fh.read())
    text = "\n".join(texts)
    missing = [e for e in sorted(os.listdir(GOLD))
               if e not in NOT_HELD and f'"{e}' not in text
               and f"'{e}" not in text and f"/{e}" not in text]
    assert not missing
    assert len(os.listdir(GOLD)) > 90
