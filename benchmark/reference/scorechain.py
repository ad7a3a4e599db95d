"""scoreChain's output: every input chain, in input order, with its
blocks unchanged and its score replaced by the global score."""

from __future__ import annotations

import os

from .common import read_chains, same_place, scorer, write_chains


def check(workload: dict, config: dict, outputs: list[str]) -> list:
    """[(name, value)] of the numbers compared; each limit is the
    traffic file's."""
    want = workload["chains"]
    got = read_chains(outputs[0])
    exact = scorer(workload, config).scores(want)
    wrong = abs(len(got) - len(want))
    gaps = [0.0]
    for c, w, s in zip(got, want, exact):
        if c["id"] != w["id"] or not same_place(c, w):
            wrong += 1
        else:
            gaps.append(abs(c["score"] - s))
    return [("chains_wrong", wrong), ("score_gap_max", max(gaps))]


def control(workload: dict, config: dict, out_dir: str, dtype) -> list[str]:
    want = workload["chains"]
    scores = scorer(workload, config, dtype).scores(want)
    path = os.path.join(out_dir, "control.chain")
    write_chains(path, [dict(c, score=float(s))
                        for c, s in zip(want, scores)])
    return [path]

