"""chainCleaner's output on the planted workload, worked out from the plan.

Each scenario's break is tested as chainCleaner tests it
(testAndRemoveSuspect, with the configuration's thresholds): the suspect
(P's block between its two large gaps) is removed when its local score, the
larger of 0 and its block's score, is at most maxSuspectScore, both the left
and the right fill of the broken chain C (its runs before and after the
suspect) score at least LRfoldThreshold times it, the whole of C at least
foldThreshold times it, and C scores at least minBrokenChainScore.  The
test gives C its exact score.  Where the suspect goes, P loses it and is
rescored, and the suspect is written as a chain of its own (a new id) with
its own score and listed in the BED with the ids of P and C; elsewhere P
keeps its blocks and its file score.  Each bulk chain passes through with
its file score.  The chains are in score order (chainSort)."""

from __future__ import annotations

import os
import re

import numpy as np

from .common import (order_violations, read_chains, same_place, scorer,
                     write_chains)

SUSPECT = 10     # the suspect's row among P's 21 blocks (workloads/cleaner)
LEFT_RUN = 8     # C's blocks before the suspect, of its 16
_BED_NAME = re.compile(r"breakingChainID_(\d+)_.*brokenChainID_(\d+)_")


def expected(workload: dict, config: dict, dtype=np.float64):
    """(chains, bed): chains as dicts, the suspects with id None; bed a
    sorted list of (chrom, start, end, breaking id, broken id)."""
    n_s = workload["n_scenarios"]
    chains = workload["chains"]
    th = config["cleaner_thresholds"]
    ps, cs = chains[:n_s], chains[n_s:2 * n_s]
    kept = [dict(p, blocks=np.delete(p["blocks"], SUSPECT, 0)) for p in ps]
    sus = [dict(p, id=None, blocks=p["blocks"][SUSPECT:SUSPECT + 1])
           for p in ps]
    left = [dict(c, blocks=c["blocks"][:LEFT_RUN]) for c in cs]
    right = [dict(c, blocks=c["blocks"][LEFT_RUN:]) for c in cs]
    sc = scorer(workload, config, dtype).scores(kept + list(cs) + sus
                                                 + left + right)
    k_sc, c_sc, s_sc, l_sc, r_sc = sc.reshape(5, n_s)
    out, bed = [], []
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(n_s):
            local = max(0.0, s_sc[i])
            removed = (l_sc[i] / local >= th["LRfoldThreshold"]
                       and r_sc[i] / local >= th["LRfoldThreshold"]
                       and c_sc[i] / local >= th["foldThreshold"]
                       and local <= th["maxSuspectScore"]
                       and cs[i]["score"] >= th["minBrokenChainScore"])
            out.append(dict(cs[i], score=float(c_sc[i])))
            if removed:
                out.append(dict(kept[i], score=float(k_sc[i])))
                out.append(dict(sus[i], score=float(s_sc[i])))
                p = ps[i]
                bed.append((p["t_name"], int(p["blocks"][SUSPECT, 0]),
                            int(p["blocks"][SUSPECT, 1]), p["id"],
                            cs[i]["id"]))
            else:
                out.append(ps[i])
    out += chains[2 * n_s:]
    return out, sorted(bed)


def read_bed(path: str) -> list:
    """[(name, value)] of the numbers compared; each limit is the
    traffic file's."""
    rows = []
    with open(path) as f:
        for ln in f:
            w = ln.split()
            if not w:
                continue
            m = _BED_NAME.search(w[3]) if len(w) > 3 else None
            rows.append((w[0], int(w[1]), int(w[2]),
                         int(m.group(1)) if m else None,
                         int(m.group(2)) if m else None))
    return sorted(rows)


def check(workload: dict, config: dict, outputs: list[str]) -> list:
    want, bed = expected(workload, config)
    got = read_chains(outputs[0])
    by_id = {c["id"]: c for c in want if c["id"] is not None}
    n_in = len(workload["chains"])
    suspects = {}
    for c in want:
        if c["id"] is None:
            suspects.setdefault(c["blocks"].tobytes() + c["q_strand"].encode(),
                                []).append(c)
    wrong = order_violations(got)
    gaps = [0.0]
    seen, found = set(), set()
    for c in got:
        if c["id"] in seen:
            wrong += 1
            continue
        seen.add(c["id"])
        w = by_id.get(c["id"])
        if w is None and c["id"] > n_in:
            key = c["blocks"].tobytes() + c["q_strand"].encode()
            w = suspects[key].pop() if suspects.get(key) else None
        if w is None or not same_place(c, w):
            wrong += 1
            continue
        found.add(id(w))
        gaps.append(abs(c["score"] - w["score"]))
    wrong += sum(1 for c in want if id(c) not in found)
    got_bed = read_bed(outputs[1])
    bed_wrong = len(set(got_bed) ^ set(bed)) + (len(got_bed)
                                                 - len(set(got_bed)))
    return [("chains_wrong", wrong), ("score_gap_max", max(gaps)),
            ("bed_wrong", bed_wrong)]


def control(workload: dict, config: dict, out_dir: str, dtype) -> list[str]:
    want, bed = expected(workload, config, dtype)
    next_id = len(workload["chains"])
    chains = []
    for c in want:
        if c["id"] is None:
            next_id += 1
            c = dict(c, id=next_id)
        chains.append(c)
    chains.sort(key=lambda c: -c["score"])
    paths = [os.path.join(out_dir, "control.chain"),
             os.path.join(out_dir, "control.bed")]
    write_chains(paths[0], chains)
    with open(paths[1], "w") as f:
        for chrom, s, e, p, c in bed:
            f.write(f"{chrom}\t{s}\t{e}\tbreakingChainID_{p}_"
                    f"brokenChainID_{c}_\t1000\t+\t{s}\t{e}\t0,0,153\n")
    return paths
