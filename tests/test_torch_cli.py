"""The port's slice as a whole: its CLI on the CPU, byte for byte.

scoreChain, chainNet -rescore and chainCleaner through
genomealignmenttools_tpu_torch.cli.main with -device=cpu must write exactly
the C goldens and exactly what the JAX package's CLI writes, and must score
through the port's scorer (its dispatch counter moves); in pair mode
(GAT_RESCORE=pair GAT_COMBINE=device) they must write the same goldens, and
chainNet -rescore and chainCleaner must go through the device combine.  Other commands are
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
    assert port_main(["FilterChainsNetFilterNets", "x", "-device=cpu"]) == 255
    assert port_main(["noSuchTool"]) == 255


def _filter_chains_args(fix, out):
    f = lambda n: os.path.join(fix, n)  # noqa: E731
    return [f("synthetic.scored.sorted.chain"), f("cleaner_input.net"),
            os.path.join(out, "filtered.chain"),
            os.path.join(out, "filtered.net"), f("target.2bit"),
            f("query.2bit"), f("target.chrom.sizes"), f("query.chrom.sizes")]


def _check_filter_chains(golden_dir, out):
    for name in ("chain", "net"):
        assert _read(os.path.join(out, f"filtered.{name}")) == _read(
            os.path.join(golden_dir, f"filterChains.filtered.{name}"))


def test_filter_chains_net_filter_nets_cli(fixtures_dir, golden_dir,
                                           tmp_path):
    """FilterChainsNetFilterNets runs in the port (chainNet -rescore
    through the port's scorer), byte-identical to the goldens."""
    perf_reset()
    assert port_main(["FilterChainsNetFilterNets"]
                     + _filter_chains_args(fixtures_dir, str(tmp_path))
                     + ["-minScore=50000,200000", "-minSizeT=1000,0",
                        "-minSizeQ=1000,0", "-device=cpu"]) == 0
    assert PERF["dispatches"] > 0
    _check_filter_chains(golden_dir, str(tmp_path))


def test_filter_chains_net_filter_nets_work_dir(fixtures_dir, golden_dir,
                                                tmp_path):
    """The checkpointed variant: golden, and a rerun skips every stage."""
    from genomealignmenttools_tpu_torch.engines.drivers import \
        filter_chains_net_filter_nets
    args = _filter_chains_args(fixtures_dir, str(tmp_path)) + [
        [50000, 200000], [1000, 0], [1000, 0]]
    work = str(tmp_path / "work")
    perf_reset()
    filter_chains_net_filter_nets(*args, work_dir=work, device="cpu")
    assert PERF["dispatches"] > 0
    _check_filter_chains(golden_dir, str(tmp_path))
    perf_reset()
    filter_chains_net_filter_nets(*args, work_dir=work, device="cpu")
    assert PERF["dispatches"] == 0
    _check_filter_chains(golden_dir, str(tmp_path))


THRESHOLDS = [
    ("lrfold60", "-LRfoldThreshold=60"),
    ("fold80", "-foldThreshold=80"),
    ("maxsus8000", "-maxSuspectScore=8000"),
    ("minbroken1500k", "-minBrokenChainScore=1500000"),
    ("minlrgap21k", "-minLRGapSize=21000"),
    ("maxbases200", "-maxSuspectBases=200"),
]


@pytest.mark.parametrize("tag,flag", THRESHOLDS)
def test_chain_cleaner_threshold_flags_match_goldens(fixtures_dir, golden_dir,
                                                     tmp_path, tag, flag):
    """The port CLI's own parse of chainCleaner's threshold flags, held
    against the live-C goldens of tests/test_chain_cleaner_thresholds.py."""
    _check_cleaner_thresholds(fixtures_dir, golden_dir, tmp_path, tag, flag)


def _check_cleaner_thresholds(fixtures_dir, golden_dir, tmp_path, tag, flag):
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


@pytest.fixture
def pair_mode(monkeypatch):
    """GAT_RESCORE=pair GAT_COMBINE=device; returns the list that counts
    the pair scorer's calls of the combine wrapper."""
    from genomealignmenttools_tpu_torch.ops import pair_rescore
    monkeypatch.setenv("GAT_RESCORE", "pair")
    monkeypatch.setenv("GAT_COMBINE", "device")
    calls = []
    real = pair_rescore.pair_combine_scan

    def spy(*args):
        calls.append(args[0].numel())
        return real(*args)
    monkeypatch.setattr(pair_rescore, "pair_combine_scan", spy)
    return calls


@pytest.mark.parametrize("tool", ["scoreChain", "chainNetRescore",
                                  "chainCleaner", "chainCleanerNet"])
def test_port_cli_pair_mode_matches_goldens(fixtures_dir, golden_dir,
                                            tmp_path, pair_mode, tool):
    """Pair mode with the device combine: the goldens byte for byte;
    chainNet -rescore and chainCleaner go through the combine (scoreChain
    takes score_table and the native combine, as the reference does)."""
    argv, outputs = _tools(fixtures_dir, str(tmp_path))[tool]
    perf_reset()
    assert port_main(argv + ["-device=cpu"]) == 0
    assert PERF["dispatches"] > 0
    assert (len(pair_mode) > 0) == (tool != "scoreChain")
    for got, golden in outputs:
        assert _read(got) == _read(os.path.join(golden_dir, golden))


@pytest.mark.parametrize("tag,flag", THRESHOLDS)
def test_chain_cleaner_threshold_flags_pair_mode(fixtures_dir, golden_dir,
                                                 tmp_path, pair_mode, tag,
                                                 flag):
    _check_cleaner_thresholds(fixtures_dir, golden_dir, tmp_path, tag, flag)
    assert pair_mode
