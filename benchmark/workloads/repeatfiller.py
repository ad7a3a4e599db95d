"""The RepeatFiller workload: one chain whose every gap hides a planted,
diverged homolog with indels, made from a seed.

A frozen copy of the port's `utils/bench_workload.py`
`build_repeatfiller_workload` (the same geometry and identities): anchor
blocks of 500 bases at 97% identity, 2,000-base gaps on both sides; inside
each gap, 400 bases in, a 150-base piece at 95% (above lastz's K=1500) and
eight 60-base pieces at 92%, each shifted 1-3 target bases from the last,
which only the banded gapped extension joins across the indels.

The returned dict holds the file paths, the work units of one call
(`gaps`), the genome codes, the chain and the plan (`pieces`: per gap, rows
of target start, query start, length) that the reference reads."""

from __future__ import annotations

import os

import numpy as np

from ..lib.seqfiles import chain_text, write_twobit

ANCHOR, GAP = 500, 2000
HOMOLOG_AT, FIRST_LEN, PIECES, PIECE_LEN = 400, 150, 8, 60


def _plant(rng, t_codes, q_codes, tp, qp, length, identity):
    frag = t_codes[tp:tp + length].copy()
    mut = rng.random(length) > identity
    frag[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)
    q_codes[qp:qp + length] = frag


def generate(seed: int, params: dict, out_dir: str) -> dict:
    n_gaps = int(params["n_gaps"])
    rng = np.random.default_rng(seed)
    t_size = q_size = n_gaps * (ANCHOR + GAP) + ANCHOR + 20_000
    t_codes = np.frombuffer(rng.bytes(t_size), np.uint8) & 3
    q_codes = np.frombuffer(rng.bytes(q_size), np.uint8) & 3
    blocks, pieces = [], []
    tp = qp = 1000
    for i in range(n_gaps):
        _plant(rng, t_codes, q_codes, tp, qp, ANCHOR, 0.97)
        blocks.append((tp, tp + ANCHOR, qp, qp + ANCHOR))
        tp += ANCHOR
        qp += ANCHOR
        ht, hq = tp + HOMOLOG_AT, qp + HOMOLOG_AT
        rows = [(ht, hq, FIRST_LEN)]
        _plant(rng, t_codes, q_codes, ht, hq, FIRST_LEN, 0.95)
        ht += FIRST_LEN
        hq += FIRST_LEN
        for j in range(PIECES):
            ht += 1 + (i + j) % 3
            rows.append((ht, hq, PIECE_LEN))
            _plant(rng, t_codes, q_codes, ht, hq, PIECE_LEN, 0.92)
            ht += PIECE_LEN
            hq += PIECE_LEN
        pieces.append(np.array(rows, np.int64))
        tp += GAP
        qp += GAP
    _plant(rng, t_codes, q_codes, tp, qp, ANCHOR, 0.97)
    blocks.append((tp, tp + ANCHOR, qp, qp + ANCHOR))
    chain = {"score": 10_000_000, "t_name": "chrT", "t_size": t_size,
             "q_name": "chrQ", "q_size": q_size, "q_strand": "+", "id": 1,
             "blocks": np.array(blocks, np.int64)}
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, v) for k, v in (
        ("chain", "in.chain"), ("t2bit", "t.2bit"), ("q2bit", "q.2bit"))}
    write_twobit(paths["t2bit"], "chrT", t_codes)
    write_twobit(paths["q2bit"], "chrQ", q_codes)
    with open(paths["chain"], "w") as f:
        f.write(chain_text([chain]))
    return {"paths": paths, "units": {"gaps": n_gaps}, "t_codes": t_codes,
            "q_codes": q_codes, "chains": [chain], "pieces": pieces}
