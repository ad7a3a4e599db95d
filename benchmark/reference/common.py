"""Pieces the checks share: the scorer of a configuration, chain matching
and the output of the control."""

from __future__ import annotations

import numpy as np

from ..lib.seqfiles import chain_text, parse_chains
from .scoring import Scorer


def scorer(workload: dict, config: dict, dtype=np.float64) -> Scorer:
    return Scorer(workload["t_codes"], workload["q_codes"],
                  config["score_matrix_acgt"],
                  config["linear_gap_tables"][config["flags"]["linear_gap"]],
                  dtype)


def read_chains(path: str) -> list[dict]:
    with open(path) as f:
        return parse_chains(f.read())


def same_place(a: dict, b: dict) -> bool:
    """Same sequences, strand and blocks (the score aside)."""
    return (a["t_name"] == b["t_name"] and a["t_size"] == b["t_size"]
            and a["q_name"] == b["q_name"] and a["q_size"] == b["q_size"]
            and a["q_strand"] == b["q_strand"]
            and a.get("t_strand", "+") == b.get("t_strand", "+")
            and a["blocks"].shape == b["blocks"].shape
            and bool(np.array_equal(a["blocks"], b["blocks"])))


def order_violations(chains: list[dict]) -> int:
    """Chains out of chainSort's order: score descending."""
    s = np.array([c["score"] for c in chains])
    return int((s[1:] > s[:-1]).sum())


def write_chains(path: str, chains: list[dict]) -> None:
    """Scores as the C tools print a double: %1.0f."""
    with open(path, "w") as f:
        f.write(chain_text([dict(c, score="%.0f" % c["score"])
                            for c in chains]))
