"""The port's slice as a whole: its CLI on the CPU, byte for byte.

scoreChain, chainNet -rescore and chainCleaner through
genomealignmenttools_tpu_torch.cli.main with -device=cpu must write exactly
the C goldens and exactly what the JAX package's CLI writes, and must score
through the port's scorer (its dispatch counter moves).  Other commands are
forwarded to the JAX CLI unchanged.
"""

import os

import pytest

from genomealignmenttools_tpu.cli.main import main as jax_main
from genomealignmenttools_tpu_torch.cli.main import main as port_main
from genomealignmenttools_tpu_torch.device import PERF, perf_reset


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _tools(fix, out):
    """(name, argv, [(output, golden)]) for the three rescoring tools."""
    f = lambda n: os.path.join(fix, n)  # noqa: E731
    o = lambda n: os.path.join(out, n)  # noqa: E731
    return {
        "scoreChain": (
            ["scoreChain", f("synthetic.chain"), f("target.2bit"),
             f("query.2bit"), o("score.chain"), "-linearGap=loose"],
            [(o("score.chain"), "scoreChain.loose.chain")]),
        "chainNetRescore": (
            ["chainNet", f("synthetic.scored.sorted.chain"),
             f("target.chrom.sizes"), f("query.chrom.sizes"), o("t.net"),
             o("q.net"), "-rescore", "-tNibDir=" + f("target.2bit"),
             "-qNibDir=" + f("query.2bit"), "-linearGap=loose"],
            [(o("t.net"), "chainNetRescore.target.net"),
             (o("q.net"), "chainNetRescore.query.net")]),
        "chainCleaner": (
            ["chainCleaner", f("synthetic.scored.sorted.chain"),
             f("target.2bit"), f("query.2bit"), o("clean.chain"),
             o("clean.bed"), "-tSizes=" + f("target.chrom.sizes"),
             "-qSizes=" + f("query.chrom.sizes"), "-linearGap=loose",
             "-verbose=0"],
            [(o("clean.chain"), "chainCleaner.out.chain"),
             (o("clean.bed"), "chainCleaner.removedSuspects.bed")]),
        "chainCleanerNet": (
            ["chainCleaner", f("synthetic.scored.sorted.chain"),
             f("target.2bit"), f("query.2bit"), o("clean.chain"),
             o("clean.bed"), "-net=" + f("cleaner_input.net"),
             "-linearGap=loose", "-verbose=0"],
            [(o("clean.chain"), "chainCleaner.out.chain"),
             (o("clean.bed"), "chainCleaner.removedSuspects.bed")]),
    }


@pytest.mark.parametrize("tool", ["scoreChain", "chainNetRescore",
                                  "chainCleaner", "chainCleanerNet"])
def test_port_cli_matches_goldens_and_jax_cli(fixtures_dir, golden_dir,
                                              tmp_path, tool):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    argv, outputs = _tools(fixtures_dir, str(port_dir))[tool]
    perf_reset()
    assert port_main(argv + ["-device=cpu"]) == 0
    # the port's scorer did the scoring (a host-native `_dev` would have
    # sent chainCleaner and chainNet -rescore around it)
    assert PERF["dispatches"] > 0
    jax_argv, jax_outputs = _tools(fixtures_dir, str(jax_dir))[tool]
    assert jax_main(jax_argv) == 0
    for (got, golden), (ref, _) in zip(outputs, jax_outputs):
        assert _read(got) == _read(os.path.join(golden_dir, golden))
        assert _read(got) == _read(ref)


@pytest.mark.parametrize("flag", ["-returnOnlyScore",
                                  "-returnOnlyScoreAndCoords",
                                  "-forceLocalScore", "-doLocalScore"])
def test_score_chain_output_modes_match_jax_cli(fixtures_dir, tmp_path,
                                                flag):
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    args = ["scoreChain", f("synthetic.chain"), f("target.2bit"),
            f("query.2bit")]
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_main(args + [port_out, "-linearGap=medium", flag,
                             "-device=cpu"]) == 0
    assert jax_main(args + [jax_out, "-linearGap=medium", flag]) == 0
    assert _read(port_out) == _read(jax_out)


def test_other_commands_are_forwarded(fixtures_dir, golden_dir, tmp_path):
    out = str(tmp_path / "swap.chain")
    perf_reset()
    assert port_main(["chainSwap", os.path.join(
        fixtures_dir, "synthetic.scored.sorted.chain"), out]) == 0
    assert _read(out) == _read(os.path.join(golden_dir, "chainSwap.chain"))
    assert PERF["dispatches"] == 0


def test_usage_and_unsupported_flags(fixtures_dir):
    assert port_main(["scoreChain", "only-one-arg", "-device=cpu"]) == 255
    assert port_main(["chainNet", "x", "-device=cpu"]) == 255
    assert port_main(["chainCleaner", "x", "-device=cpu"]) == 255
    assert port_main(["scoreChain", "a", "b", "c", "d", "-profile=/x",
                      "-device=cpu"]) == 255
    assert port_main(["noSuchTool"]) == 255


@pytest.mark.parametrize("tag,flag", [
    ("lrfold60", "-LRfoldThreshold=60"),
    ("fold80", "-foldThreshold=80"),
    ("maxsus8000", "-maxSuspectScore=8000"),
    ("minbroken1500k", "-minBrokenChainScore=1500000"),
    ("minlrgap21k", "-minLRGapSize=21000"),
    ("maxbases200", "-maxSuspectBases=200"),
])
def test_chain_cleaner_threshold_flags_match_goldens(fixtures_dir, golden_dir,
                                                     tmp_path, tag, flag):
    """The port CLI's own parse of chainCleaner's threshold flags, held
    against the live-C goldens of tests/test_chain_cleaner_thresholds.py."""
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    out_chain, out_bed = str(tmp_path / "o.chain"), str(tmp_path / "o.bed")
    assert port_main(["chainCleaner", f("synthetic.scored.sorted.chain"),
                      f("target.2bit"), f("query.2bit"), out_chain, out_bed,
                      "-net=" + f("cleaner_input.net"), "-linearGap=loose",
                      flag, "-verbose=0", "-device=cpu"]) == 0
    gold = os.path.join(golden_dir, "thresholds")
    assert _read(out_bed) == _read(os.path.join(gold, f"cc.{tag}.bed"))
    assert _read(out_chain) == _read(os.path.join(gold, f"cc.{tag}.chain"))


@pytest.mark.parametrize("mode", ["nopairs", "pairs"])
def test_chain_cleaner_do_pairs_matches_goldens(fixtures_dir, golden_dir,
                                                tmp_path, mode):
    fix = os.path.join(fixtures_dir, "pairs")
    f = lambda n: os.path.join(fix, n)  # noqa: E731
    out_chain, out_bed = str(tmp_path / "o.chain"), str(tmp_path / "o.bed")
    argv = ["chainCleaner", f("pairs.scored.sorted.chain"), f("target.2bit"),
            f("query.2bit"), out_chain, out_bed,
            "-net=" + f("pairs.input.net"), "-linearGap=loose", "-verbose=0",
            "-device=cpu"] + (["-doPairs"] if mode == "pairs" else [])
    assert port_main(argv) == 0
    gold = os.path.join(golden_dir, "pairs")
    assert _read(out_bed) == _read(os.path.join(gold,
                                                f"chainCleaner.{mode}.bed"))
    assert _read(out_chain) == _read(
        os.path.join(gold, f"chainCleaner.{mode}.out.chain"))
