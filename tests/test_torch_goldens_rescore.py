"""Port twins of the reference's golden tests that score: scoreChain,
chainCleaner, chainNet -rescore and FilterChainsNetFilterNets.

Each case feeds the reference test's inputs to the port's CLI
(genomealignmenttools_tpu_torch.cli.main, -device=cpu) or, where the
reference test hands the engine a scorer, to the port's engine at the same
relative path with the port's TorchChainScorer(device="cpu"), and compares
with the same golden byte for byte.  Every case runs in window mode and in
pair mode (GAT_RESCORE=pair GAT_COMBINE=device, int8 tiles), and must score
through the port (PERF["dispatches"] moves); in pair mode chainNet -rescore,
chainCleaner and FilterChainsNetFilterNets must reach the device combine's
wrapper (scoreChain takes score_table and the native combine there, as the
reference does).  The CLI cases are the table of
tests/golden_cases.py, which chip_smoke.py also runs on the card;
a (case, mode) an older test of the port already holds (its HELD_ELSEWHERE)
is not run again here.

Not twinned here: tests/test_chain_cleaner_thresholds.py and the -doPairs
goldens (tests/test_torch_cli.py holds them in both modes), and the
reference tests whose port twins are older files: test_pallas_band.py
(test_torch_band.py), test_pallas_combine.py (test_torch_pair_combine.py),
test_device_rescore.py (test_torch_rescore.py), test_parallel.py
(test_torch_parallel.py), test_two_process_distributed.py
(test_torch_distributed.py).
"""

import functools
import io
import os

import pytest

import golden_cases as gc
from genomealignmenttools_tpu_torch.cli.main import main as port_main
from genomealignmenttools_tpu_torch.device import PERF, perf_reset

TIER1_MODES = ("window", "pair")
CASES = [(case, mode) for case in gc.scoring_cases("") for mode in TIER1_MODES
         if (case, mode) not in gc.HELD_ELSEWHERE]


@pytest.fixture
def combine_calls(monkeypatch):
    """The calls of the device combine's wrapper by the pair scorer."""
    from genomealignmenttools_tpu_torch.ops import pair_rescore
    calls = []
    real = pair_rescore.pair_combine_scan_tiles

    def spy(*args):
        calls.append(args[0].shape[0])
        return real(*args)
    monkeypatch.setattr(pair_rescore, "pair_combine_scan_tiles", spy)
    return calls


def check_scored(mode: str, tool: str, combine_calls: list) -> None:
    assert PERF["dispatches"] > 0
    assert (len(combine_calls) > 0) == (mode != "window"
                                        and tool != "scoreChain")


@pytest.mark.parametrize("case,mode", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_scoring_golden_through_port_cli(tmp_path, monkeypatch,
                                         combine_calls, case, mode):
    argv, env, outputs = gc.scoring_cases(str(tmp_path))[case]
    gc.set_mode(monkeypatch, mode, env)
    monkeypatch.chdir(tmp_path)
    perf_reset()
    assert port_main(argv + ["-device=cpu"]) == 0
    check_scored(mode, argv[0], combine_calls)
    for got, golden in outputs:
        assert gc.first_difference(got, golden) is None


CC = ["chainCleaner.out.chain", "chainCleaner.removedSuspects.bed"]
# the goldens each case of the table compares with, as its reference test
# does (None: the output must be empty)
GOLDENS = {
    "score_chain_parity-loose": ["scoreChain.loose.chain"],
    "score_chain_parity-medium": ["scoreChain.medium.chain"],
    "score_chain_parity-hoxd55": ["scoreChain.hoxd55.chain"],
    "score_chain_parity-return_only_score": ["scoreChain.scores.tsv"],
    "score_chain_parity-return_only_score_and_coords":
        ["scoreChain.coords.tsv"],
    "score_chain_parity-force_local_score": ["scoreChain.local.chain"],
    "score_chain_parity-nib_dir_inputs": ["scoreChain.loose.chain"],
    "score_chain_parity-chain_cleaner_nib_dir_inputs": CC,
    "chain_cleaner_parity-with_net": CC,
    "chain_cleaner_parity-internal_netting": CC,
    "chain_cleaner_parity-fused_vs_text_breaks": CC,
    "chain_cleaner_parity-debug_flag": CC + [
        "chainCleaner.debug/" + n for n in gc.DEBUG_DUMPS],
    "chain_cleaner_parity-suspect_data_file": [
        "chainCleaner.suspectData.out.chain", None,
        "chainCleaner.suspectData.tsv"],
    "chain_cleaner_parity-only_this": ["chainCleaner.onlyThis.out.chain",
                                       "chainCleaner.onlyThis.bed"],
    "meta_passthrough-chain_cleaner_meta": ["meta.chainCleaner.chain",
                                            "meta.chainCleaner.bed"],
    "chain_net_parity-rescore": ["chainNetRescore.target.net",
                                 "chainNetRescore.query.net"],
    "drivers-filter_chains_pipeline_parity": ["filterChains.filtered.chain",
                                              "filterChains.filtered.net"],
    **{f"chain_cleaner_thresholds-{t}": [f"thresholds/cc.{t}.chain",
                                         f"thresholds/cc.{t}.bed"]
       for t, _ in gc.THRESHOLDS},
    **{f"chain_cleaner_pairs-{t}": [f"pairs/chainCleaner.{g}.out.chain",
                                    f"pairs/chainCleaner.{g}.bed"]
       for t, g in (("nopairs", "nopairs"), ("pairs", "pairs"),
                    ("pairs_python_oracle", "pairs"))},
}


def test_every_case_compares_with_its_reference_test_s_goldens():
    """The table holds each case to the goldens its reference test compares
    with, no more and no fewer."""
    got = {case: [g and os.path.relpath(g, gc.GOLD) for _, g in outputs]
           for case, (_, _, outputs) in gc.scoring_cases("").items()}
    assert got == GOLDENS


@pytest.mark.parametrize("mode", TIER1_MODES)
def test_chain_cleaner_zero_removal_score_side_effect(tmp_path, monkeypatch,
                                                      combine_calls, mode):
    """test_chain_cleaner_parity.py:168-212: a run that removes nothing still
    writes the recomputed scores; GAT_BREAK_LOOP=1 and =0 give the same
    bytes, and the scores differ from the perturbed input."""
    perturbed = gc.perturbed_input(str(tmp_path / "perturbed.chain"))
    outs = {}
    for loop in ("1", "0"):
        out = tmp_path / f"loop{loop}"
        out.mkdir()
        gc.set_mode(monkeypatch, mode, {"GAT_BREAK_LOOP": loop})
        perf_reset()
        assert port_main(gc.zero_removal_argv(
            str(tmp_path / "perturbed.chain"), str(out))
            + ["-device=cpu"]) == 0
        check_scored(mode, "chainCleaner", combine_calls)
        outs[loop] = ((out / "c.chain").read_text(),
                      (out / "c.bed").read_text())
    assert outs["1"][1] == outs["0"][1] == ""
    assert outs["1"][0] == outs["0"][0]
    assert outs["1"][0] != perturbed


@pytest.mark.parametrize("mode", TIER1_MODES)
def test_chain_cleaner_sharded_merge_parity(fixtures_dir, golden_dir,
                                            tmp_path, monkeypatch,
                                            combine_calls, mode):
    """test_chain_cleaner_parity.py:98-126 through the CLI: 2 and 3 shards
    (-numShards, -shard, -shardOut), merged by -mergeShards, give the
    goldens."""
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    gc.set_mode(monkeypatch, mode)
    for n in (2, 3):
        paths = []
        perf_reset()
        for s in range(n):
            paths.append(str(tmp_path / f"shard_{n}_{s}.json"))
            assert port_main([
                "chainCleaner", f("synthetic.scored.sorted.chain"),
                f("target.2bit"), f("query.2bit"),
                str(tmp_path / "unused.chain"), str(tmp_path / "unused.bed"),
                "-tSizes=" + f("target.chrom.sizes"),
                "-qSizes=" + f("query.chrom.sizes"), "-linearGap=loose",
                f"-numShards={n}", f"-shard={s}", "-shardOut=" + paths[-1],
                "-verbose=0", "-device=cpu"]) == 0
        check_scored(mode, "chainCleaner", combine_calls)
        out_chain = str(tmp_path / f"merged_{n}.chain")
        out_bed = str(tmp_path / f"merged_{n}.bed")
        assert port_main(["chainCleaner", "-mergeShards=" + ",".join(paths),
                          out_chain, out_bed]) == 0
        assert gc.first_difference(out_chain, os.path.join(
            golden_dir, "chainCleaner.out.chain")) is None, n
        assert gc.first_difference(out_bed, os.path.join(
            golden_dir, "chainCleaner.removedSuspects.bed")) is None, n


def _port_scorer():
    """The reference tests' DeviceChainScorer, in the port: the torch
    scorer on the CPU, in the mode GAT_RESCORE names."""
    from genomealignmenttools_tpu_torch.ops.rescore import TorchChainScorer
    return functools.partial(TorchChainScorer, device="cpu")


@pytest.mark.parametrize("mode", TIER1_MODES)
def test_chain_cleaner_batched_device_path(fixtures_dir, golden_dir,
                                           tmp_path, monkeypatch,
                                           combine_calls, mode):
    """test_chain_cleaner_parity.py:81-96 with the port's scorer handed to
    the port's clean_chains as scorer_factory."""
    from genomealignmenttools_tpu_torch.engines.chain_cleaner import \
        clean_chains
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    gc.set_mode(monkeypatch, mode)
    out_chain, out_bed = str(tmp_path / "c.chain"), str(tmp_path / "c.bed")
    perf_reset()
    clean_chains(f("synthetic.scored.sorted.chain"), f("target.2bit"),
                 f("query.2bit"), out_chain, out_bed,
                 t_sizes=f("target.chrom.sizes"),
                 q_sizes=f("query.chrom.sizes"), linear_gap="loose",
                 scorer_factory=_port_scorer())
    check_scored(mode, "chainCleaner", combine_calls)
    assert gc.first_difference(out_chain, os.path.join(
        golden_dir, "chainCleaner.out.chain")) is None
    assert gc.first_difference(out_bed, os.path.join(
        golden_dir, "chainCleaner.removedSuspects.bed")) is None


@pytest.mark.parametrize("mode", TIER1_MODES)
def test_chain_net_rescore_batched_device(fixtures_dir, golden_dir,
                                          monkeypatch, combine_calls, mode):
    """test_chain_net_parity.py:48-59 with the port's scorer handed to the
    port's chain_net as scorer_factory."""
    from genomealignmenttools_tpu_torch.engines.chain_net import chain_net
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    gc.set_mode(monkeypatch, mode)
    t_out, q_out = io.StringIO(), io.StringIO()
    perf_reset()
    chain_net(f("synthetic.scored.sorted.chain"), f("target.chrom.sizes"),
              f("query.chrom.sizes"), t_out, q_out, rescore=True,
              t_2bit=f("target.2bit"), q_2bit=f("query.2bit"),
              linear_gap="loose", scorer_factory=_port_scorer())
    check_scored(mode, "chainNet", combine_calls)
    for text, name in ((t_out, "target"), (q_out, "query")):
        with open(os.path.join(golden_dir,
                               f"chainNetRescore.{name}.net")) as fh:
            assert text.getvalue() == fh.read()


def test_every_scoring_case_runs_in_both_modes_somewhere():
    """Every (case, window or pair) of the table runs here or is named as
    held by an older test of the port (HELD_ELSEWHERE), and each older test
    named exists.  Whether that test compares with the case's goldens is
    read from its source, not checked here."""
    cases = gc.scoring_cases("")
    assert {c for c, _ in gc.HELD_ELSEWHERE} <= set(cases)
    assert {m for _, m in gc.HELD_ELSEWHERE} <= set(TIER1_MODES)
    for test in set(gc.HELD_ELSEWHERE.values()):
        path, name = test.split("::")
        with open(os.path.join(gc.HERE, path)) as fh:
            assert f"def {name}(" in fh.read(), test
