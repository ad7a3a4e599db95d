"""The frozen generators make the same inputs from the same seed, and
other inputs of the same shape from another seed."""

import hashlib
import os

import numpy as np
import pytest

from benchmark.workloads import cleaner, repeatfiller

CASES = [(cleaner, {"n_scenarios": 6, "n_bulk": 40}),
         (repeatfiller, {"n_gaps": 5})]


def _digests(paths: dict) -> dict:
    return {k: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for k, p in paths.items()}


@pytest.mark.parametrize("gen,params", CASES,
                         ids=[g.__name__.rsplit(".", 1)[1] for g, _ in CASES])
def test_same_seed_same_inputs(tmp_path, gen, params):
    seed = 2 ** 31 + 123_457          # more than 32 signed bits hold
    a = gen.generate(seed, params, str(tmp_path / "a"))
    b = gen.generate(seed, params, str(tmp_path / "b"))
    c = gen.generate(seed + 1, params, str(tmp_path / "c"))
    assert _digests(a["paths"]) == _digests(b["paths"])
    assert np.array_equal(a["t_codes"], b["t_codes"])
    assert np.array_equal(a["q_codes"], b["q_codes"])
    assert _digests(a["paths"])["t2bit"] != _digests(c["paths"])["t2bit"]
    # the same shape: sizes, chain count, block count, gaps
    assert a["t_codes"].shape == c["t_codes"].shape
    assert len(a["chains"]) == len(c["chains"])
    assert [len(x["blocks"]) for x in a["chains"]] == \
        [len(x["blocks"]) for x in c["chains"]]
    assert set(a["units"]) == set(c["units"])
    for p in a["paths"].values():
        assert os.path.getsize(p) > 0


def test_cleaner_plan_is_planted(tmp_path):
    """Each scenario's anchors are copies of the target at about 93%
    identity, on the right strand."""
    w = cleaner.generate(5, {"n_scenarios": 6, "n_bulk": 10},
                         str(tmp_path))
    q_rc = w["q_codes"][::-1] ^ 2
    for c in w["chains"][:6]:
        q = w["q_codes"] if c["q_strand"] == "+" else q_rc
        ts, te, qs, qe = c["blocks"][0]
        same = (w["t_codes"][ts:te] == q[qs:qe]).mean()
        assert 0.88 < same < 0.99


def test_repeatfiller_plan_is_planted(tmp_path):
    w = repeatfiller.generate(5, {"n_gaps": 4}, str(tmp_path))
    for pieces in w["pieces"]:
        for t, q, n in pieces:
            same = (w["t_codes"][t:t + n] == w["q_codes"][q:q + n]).mean()
            assert same > 0.85
