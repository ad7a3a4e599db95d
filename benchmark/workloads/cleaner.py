"""The chainCleaner workload: one chromosome pair with planted break
scenarios and bulk pass-through chains, made from a seed.

A frozen, vectorised copy of the port's `utils/bench_workload.py`
`build_cleaner_workload` (the same geometry, identities and file scores).
Left out: `_enforce_tie_free`, which re-plants scenario chains until no two
output scores are equal, for the C tool's chainSort; nothing here needs it.

Per scenario i: a breaking chain P = 10 anchor blocks, a weak suspect block
20 kb further on, 10 more anchor blocks 22 kb after it; and a broken chain C
whose two runs of 8 blocks fill P's two large gaps.  chainCleaner removes the
suspect from P, writes it as a chain of its own and lists it in the BED.
Bulk chains are 12 small colinear blocks each, which pass through unchanged.

The returned dict holds the file paths, the work units of one call
(`aligned_bases`), the genome codes and the plan (`scenarios`, `bulk`) that
the reference reads."""

from __future__ import annotations

import os

import numpy as np

from ..lib.seqfiles import chain_text, write_twobit

SCEN_SPAN_T, SCEN_SPAN_Q = 120_000, 90_000
BULK_SPAN = 3_000
PLANT_CHUNK = 1 << 24     # bases planted per numpy pass


def _colinear(rng, t0, q0, n, size, gap_lo, gap_hi):
    """(k, n, 4) blocks: k chains of n blocks of size[k] with gaps drawn in
    [gap_lo, gap_hi) on each side."""
    k = t0.shape[0]
    gt = rng.integers(gap_lo, gap_hi, (k, n))
    gq = rng.integers(gap_lo, gap_hi, (k, n))
    step_t = size[:, None] + gt[:, :-1]
    step_q = size[:, None] + gq[:, :-1]
    zero = np.zeros((k, 1), np.int64)
    ts = t0[:, None] + np.concatenate([zero, np.cumsum(step_t, 1)], 1)
    qs = q0[:, None] + np.concatenate([zero, np.cumsum(step_q, 1)], 1)
    sz = np.broadcast_to(size[:, None], ts.shape)
    return np.stack([ts, ts + sz, qs, qs + sz], 2).astype(np.int64)


def plant(rng, t_codes, q_codes, blocks, minus, identity):
    """Copy target block content into the query at each block's query
    coordinates (on the reverse complement for minus-strand blocks) with
    about (1 - identity) point divergence.  blocks (m, 4), minus and
    identity (m,); the minus-strand blocks are planted after the others."""
    thresh = np.round((1.0 - identity) * 256).astype(np.uint8)
    q_last = q_codes.shape[0] - 1
    for neg in (False, True):
        sel = minus == neg
        b, th = blocks[sel], thresh[sel]
        sizes = b[:, 1] - b[:, 0]
        ends = np.cumsum(sizes)
        lo = 0
        while lo < len(sizes):
            hi = max(lo + 1, int(np.searchsorted(
                ends, ends[lo] - sizes[lo] + PLANT_CHUNK, "right")))
            sz = sizes[lo:hi]
            first = np.cumsum(sz) - sz
            ar = np.arange(int(sz.sum()), dtype=np.int64)
            frag = t_codes[np.repeat(b[lo:hi, 0] - first, sz) + ar]
            draw = np.frombuffer(rng.bytes(ar.size), np.uint8)
            mut = draw < np.repeat(th[lo:hi], sz)
            frag[mut] = np.frombuffer(rng.bytes(int(mut.sum())),
                                      np.uint8) & 3
            if neg:
                q_codes[np.repeat(q_last - b[lo:hi, 2] + first, sz) - ar] = \
                    frag ^ 2
            else:
                q_codes[np.repeat(b[lo:hi, 2] - first, sz) + ar] = frag
            lo = hi


def generate(seed: int, params: dict, out_dir: str) -> dict:
    n_s = int(params["n_scenarios"])
    n_b = int(params["n_bulk"])
    rng = np.random.default_rng(seed)
    t_size = n_s * SCEN_SPAN_T + n_b * BULK_SPAN + 100_000
    q_size = n_s * SCEN_SPAN_Q + n_b * BULK_SPAN + 100_000
    t_codes = np.frombuffer(rng.bytes(t_size), np.uint8) & 3
    q_codes = np.frombuffer(rng.bytes(q_size), np.uint8) & 3

    i = np.arange(n_s, dtype=np.int64)
    minus = i % 3 == 0
    t0 = i * SCEN_SPAN_T + 10_000
    q0 = np.where(minus, q_size - i * SCEN_SPAN_Q - 55_000,
                  i * SCEN_SPAN_Q + 5_000)
    a_bs = 1200 + i % 800
    sus_len = 200 + (i * 7) % 1400
    b_bs = 800 + (i * 13) % 300
    a_blk = _colinear(rng, t0, q0, 10, a_bs, 10, 200)
    gap1 = a_blk[:, -1, 1]
    sus_t = gap1 + 20_000
    sus_q = a_blk[:, -1, 3] + 900
    s_blk = np.stack([sus_t, sus_t + sus_len, sus_q, sus_q + sus_len],
                     1)[:, None, :]
    b_blk = _colinear(rng, sus_t + sus_len + 22_000, sus_q + sus_len + 1200,
                      10, a_bs, 10, 200)
    cq0 = i * SCEN_SPAN_Q + 61_000
    l_blk = _colinear(rng, gap1 + 500, cq0, 8, b_bs, 5, 120)
    r_blk = _colinear(rng, sus_t + sus_len + 500, l_blk[:, -1, 3] + 400, 8,
                      b_bs, 5, 120)
    p_blk = np.concatenate([a_blk, s_blk, b_blk], 1)       # (n_s, 21, 4)
    c_blk = np.concatenate([l_blk, r_blk], 1)              # (n_s, 16, 4)

    j = np.arange(n_b, dtype=np.int64)
    b_minus = j % 4 == 0
    bt0 = n_s * SCEN_SPAN_T + 50_000 + j * BULK_SPAN
    bq = n_s * SCEN_SPAN_Q + 50_000 + j * BULK_SPAN
    bq0 = np.where(b_minus, q_size - (bq + 2_900), bq + 100)
    bulk_size = rng.integers(60, 180, n_b)
    bulk_blk = _colinear(rng, bt0, bq0, 12, bulk_size, 0, 50)

    # identities as the port's generator plants them: anchors 0.93, the
    # suspect 0.78, the broken chain 0.94 (plus strand), bulk 0.90
    p_ident = np.array([0.93] * 10 + [0.78] + [0.93] * 10)
    plant(rng, t_codes, q_codes,
          np.concatenate([p_blk.reshape(-1, 4), c_blk.reshape(-1, 4),
                          bulk_blk.reshape(-1, 4)]),
          np.concatenate([np.repeat(minus, 21), np.zeros(n_s * 16, bool),
                          np.repeat(b_minus, 12)]),
          np.concatenate([np.tile(p_ident, n_s), np.full(n_s * 16, 0.94),
                          np.full(n_b * 12, 0.90)]))

    # file order is score order, ids 1..N in it: P (5,000,000 - i), then C
    # (400,000 - i), then bulk (100,001 + j) from the highest j down
    chains = []
    for k in range(n_s):
        chains.append({"score": 5_000_000 - k, "blocks": p_blk[k],
                       "q_strand": "-" if minus[k] else "+"})
    for k in range(n_s):
        chains.append({"score": 400_000 - k, "blocks": c_blk[k],
                       "q_strand": "+"})
    for k in range(n_b - 1, -1, -1):
        chains.append({"score": 100_001 + k, "blocks": bulk_blk[k],
                       "q_strand": "-" if b_minus[k] else "+"})
    for idx, c in enumerate(chains):
        c.update(id=idx + 1, t_name="chrT", t_size=t_size, q_name="chrQ",
                 q_size=q_size)

    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, v) for k, v in (
        ("chain", "in.chain"), ("t2bit", "t.2bit"), ("q2bit", "q.2bit"),
        ("t_sizes", "t.sizes"), ("q_sizes", "q.sizes"))}
    write_twobit(paths["t2bit"], "chrT", t_codes)
    write_twobit(paths["q2bit"], "chrQ", q_codes)
    with open(paths["t_sizes"], "w") as f:
        f.write(f"chrT\t{t_size}\n")
    with open(paths["q_sizes"], "w") as f:
        f.write(f"chrQ\t{q_size}\n")
    with open(paths["chain"], "w") as f:
        f.write(chain_text(chains))
    aligned = int(sum(int((c["blocks"][:, 1] - c["blocks"][:, 0]).sum())
                      for c in chains))
    return {"paths": paths, "units": {"aligned_bases": aligned,
                                      "chains": len(chains),
                                      "blocks": int(sum(len(c["blocks"])
                                                        for c in chains))},
            "t_codes": t_codes, "q_codes": q_codes, "chains": chains,
            "n_scenarios": n_s, "n_bulk": n_b}
