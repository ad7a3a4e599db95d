"""The plain reference against scores worked out by hand, and the checks
against outputs known to be right or wrong."""

import json
import os

import numpy as np
import pytest

from benchmark.reference import cleaner as ref_cleaner
from benchmark.reference import repeatfiller as ref_rf
from benchmark.reference import scorechain as ref_score
from benchmark.reference.common import read_chains, write_chains
from benchmark.reference.scoring import GapCost, Scorer
from benchmark.workloads import cleaner, repeatfiller

from conftest import REPO

CONFIG = json.load(open(os.path.join(
    REPO, "benchmark", "configs", "chainpair-planted-loose.json")))
RF_CONFIG = json.load(open(os.path.join(
    REPO, "benchmark", "configs", "gapfill-planted-loose.json")))
LOOSE = CONFIG["linear_gap_tables"]["loose"]


def codes(s: str) -> np.ndarray:
    return np.array(["TCAG".index(c) for c in s], np.uint8)


def scorer(t: str, q: str, dtype=np.float64) -> Scorer:
    return Scorer(codes(t), codes(q), CONFIG["score_matrix_acgt"], LOOSE,
                  dtype)


@pytest.mark.parametrize("dq,dt,cost", [
    (0, 0, 0),            # no gap
    (0, 1, 325),          # tGap at a table position
    (5, 0, 412),          # 400 + 50 * 2 / 8 = 412.5, truncated
    (1, 1, 660),          # bothGap of 2
    (0, 200, 622),        # 600 + 500 * 89 / 2000 = 622.25
    (150, 100, 934),      # bothGap of 250: 900 + 500 * 139 / 2000
    (0, 300_000, 68572),  # past the last position: 56600 + 0.25 * 47889
])
def test_gap_costs_by_hand(dq, dt, cost):
    assert int(GapCost(LOOSE).cost(np.array([dq]), np.array([dt]))[0]) == cost


def test_chain_scores_by_hand():
    # t: ACGT G AA T C ; q: ACGT AG A T
    s = scorer("ACGTGAATC", "ACGTAGAT")
    chain = {"q_strand": "+", "blocks": np.array(
        [[0, 4, 0, 4], [5, 7, 4, 6], [8, 9, 7, 8]], np.int64)}
    # 382 (ACGT/ACGT) + 60 (AA/AG: 91 - 31) - 31 (C/T) - 325 - 660
    assert s.scores([chain])[0] == -574
    # minus strand: the reverse complement of q is ATCTACGT
    minus = {"q_strand": "-", "blocks": np.array([[0, 4, 4, 8]], np.int64)}
    assert s.scores([minus])[0] == 382
    both = s.scores([chain, minus, chain])
    assert list(both) == [-574, 382, -574]


def test_float32_control_differs():
    """The control's running sums in float32 lose the exact score of a
    long chain, where float64 keeps it."""
    rng = np.random.default_rng(1)
    t = rng.integers(0, 4, 3_000_000).astype(np.uint8)
    chain = {"q_strand": "+", "blocks": np.array(
        [[0, 3_000_000, 0, 3_000_000]], np.int64)}
    exact = int(np.array(CONFIG["score_matrix_acgt"])[
        np.array([3, 1, 0, 2])[t], np.array([3, 1, 0, 2])[t]].sum())
    s64 = Scorer(t, t, CONFIG["score_matrix_acgt"], LOOSE, np.float64)
    s32 = Scorer(t, t, CONFIG["score_matrix_acgt"], LOOSE, np.float32)
    assert s64.scores([chain])[0] == exact
    assert s32.scores([chain])[0] != exact


@pytest.fixture(scope="module")
def small_cleaner(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cleaner"))
    return cleaner.generate(77, {"n_scenarios": 8, "n_bulk": 30}, d), d


def test_scorechain_check(small_cleaner):
    w, d = small_cleaner
    good = ref_score.control(w, CONFIG, d, np.float64)
    assert dict(ref_score.check(w, CONFIG, good)) == {
        "chains_wrong": 0, "score_gap_max": 0}
    chains = read_chains(good[0])
    chains[3]["score"] += 1
    chains[5]["blocks"] = chains[5]["blocks"] + 1
    bad = os.path.join(d, "bad.chain")
    write_chains(bad, chains)
    got = dict(ref_score.check(w, CONFIG, [bad]))
    assert got == {"chains_wrong": 1, "score_gap_max": 1}


def test_cleaner_check(small_cleaner):
    w, d = small_cleaner
    good = ref_cleaner.control(w, CONFIG, d, np.float64)
    assert dict(ref_cleaner.check(w, CONFIG, good)) == {
        "chains_wrong": 0, "score_gap_max": 0, "bed_wrong": 0}
    # the input itself: no suspect removed, no BED line
    empty = os.path.join(d, "empty.bed")
    open(empty, "w").close()
    got = dict(ref_cleaner.check(w, CONFIG, [w["paths"]["chain"], empty]))
    assert got["chains_wrong"] > 0 and got["bed_wrong"] > 0


def test_repeatfiller_check(tmp_path):
    w = repeatfiller.generate(3, {"n_gaps": 5}, str(tmp_path))
    chain = w["chains"][0]
    # a fill that follows the plan exactly: every planted piece, in order
    rows = [chain["blocks"][0]]
    for k, p in enumerate(w["pieces"]):
        rows += [np.array([t, t + n, q, q + n]) for t, q, n in p]
        rows.append(chain["blocks"][k + 1])
    exact = str(tmp_path / "exact.chain")
    write_chains(exact, [dict(chain, blocks=np.array(rows, np.int64))])
    assert dict(ref_rf.check(w, RF_CONFIG, [exact])) == {
        "gaps_unfilled": 0, "pairs_off_homolog": 0,
        "fill_block_deficit_max": 0, "fills_below_threshold": 0,
        "blocks_misplaced": 0, "homolog_missed_pct": 0.0}
    # cut after each gap's first piece: 480 of its 630 planted pairs missed
    cut = dict(ref_rf.check(w, RF_CONFIG, ref_rf.faults(
        w, str(tmp_path), [exact])["truncated"]))
    assert cut["homolog_missed_pct"] == pytest.approx(100 * 480 / 630)
    assert cut["pairs_off_homolog"] == 0 and cut["blocks_misplaced"] == 0
    # one added block moved one base along the target: off its homolog
    # and far below 0
    rows[1] = rows[1] + np.array([1, 1, 0, 0])
    moved = str(tmp_path / "moved.chain")
    write_chains(moved, [dict(chain, blocks=np.array(rows, np.int64))])
    got = dict(ref_rf.check(w, RF_CONFIG, [moved]))
    assert got["pairs_off_homolog"] == 150
    assert got["homolog_missed_pct"] == pytest.approx(100 * 150 / 3150)
    assert got["fill_block_deficit_max"] > 2000
    unfilled = dict(ref_rf.check(w, RF_CONFIG, [w["paths"]["chain"]]))
    assert unfilled["gaps_unfilled"] == 5
    assert unfilled["homolog_missed_pct"] == 100.0
    ctrl = dict(ref_rf.check(w, RF_CONFIG, ref_rf.control(
        w, RF_CONFIG, str(tmp_path), None)))
    assert ctrl["pairs_off_homolog"] > 1000
    assert ctrl["homolog_missed_pct"] > 50
