"""Sparse chaining DP over scored gapless blocks (the axtChain core).

Behavioral reference: kent/src/lib/chainBlock.c - the kd-tree
branch-and-bound predecessor search (kdBuild:124-198, bestPredecessor:
207-267, findBestPredecessors:286-309, peelChains:327-390,
chainBlocks:392-452).  The port is faithful including tie-breaking
behavior: tree construction splits lists positionally at the median, the
hi subtree is explored first, and strict `>` comparisons keep the first
best found, so chain output is identical to the C tool's.

This host implementation handles the mini-chain workloads (RepeatFiller
gap filling, small pairs); whole-genome chaining runs it per (t,q,strand)
pair.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ..formats.chain import Chain


@dataclass
class _Leaf:
    cb: list  # [tS, tE, qS, qE, score] (score int)
    total_score: float = 0.0
    best_pred: "_Branch | None" = None
    hit: bool = False


@dataclass
class _Branch:
    lo: "_Branch | None" = None
    hi: "_Branch | None" = None
    leaf: _Leaf | None = None
    cut_coord: int = 0
    max_score: float = 0.0
    max_q: int = 0
    max_t: int = 0


def _kd_build(q_list: list[_Leaf], t_list: list[_Leaf], dim: int) -> _Branch:
    """kdBuild: positional median split alternating q/t dims."""
    branch = _Branch()
    n = len(q_list)
    if n == 1:
        leaf = q_list[0]
        branch.leaf = leaf
        branch.max_q = leaf.cb[3]
        branch.max_t = leaf.cb[1]
        return branch
    dim_list = q_list if dim == 0 else t_list
    median_ix = n // 2
    hit = set()
    for i in range(median_ix):
        hit.add(id(dim_list[i]))
    last = dim_list[median_ix - 1]
    branch.cut_coord = last.cb[2] if dim == 0 else last.cb[0]
    lo_q = [lf for lf in q_list if id(lf) in hit]
    hi_q = [lf for lf in q_list if id(lf) not in hit]
    lo_t = [lf for lf in t_list if id(lf) in hit]
    hi_t = [lf for lf in t_list if id(lf) not in hit]
    next_dim = 1 - dim
    branch.lo = _kd_build(lo_q, lo_t, next_dim)
    branch.hi = _kd_build(hi_q, hi_t, next_dim)
    branch.max_q = max(branch.lo.max_q, branch.hi.max_q)
    branch.max_t = max(branch.lo.max_t, branch.hi.max_t)
    return branch


def _best_predecessor(lonely: _Leaf, connect_cost, gap_cost, dim: int,
                      branch: _Branch, best_pred, best_score):
    """bestPredecessor with branch-and-bound pruning."""
    max_score = branch.max_score + lonely.cb[4]
    if max_score < best_score:
        return best_pred, best_score
    max_score -= gap_cost(lonely.cb[2] - branch.max_q,
                          lonely.cb[0] - branch.max_t)
    if max_score < best_score:
        return best_pred, best_score
    leaf = branch.leaf
    if leaf is not None:
        if leaf.cb[2] < lonely.cb[2] and leaf.cb[0] < lonely.cb[0]:
            score = (leaf.total_score + lonely.cb[4]
                     - connect_cost(leaf.cb, lonely.cb))
            if score > best_score:
                return branch, score
        return best_pred, best_score
    new_dim = 1 - dim
    dim_coord = lonely.cb[2] if dim == 0 else lonely.cb[0]
    if dim_coord > branch.cut_coord:
        best_pred, best_score = _best_predecessor(
            lonely, connect_cost, gap_cost, new_dim, branch.hi,
            best_pred, best_score)
    return _best_predecessor(lonely, connect_cost, gap_cost, new_dim,
                             branch.lo, best_pred, best_score)


def _update_scores_on_way(branch: _Branch, dim: int, leaf: _Leaf):
    if branch.max_score < leaf.total_score:
        branch.max_score = leaf.total_score
    if branch.leaf is None:
        dim_coord = leaf.cb[2] if dim == 0 else leaf.cb[0]
        new_dim = 1 - dim
        if dim_coord <= branch.cut_coord:
            _update_scores_on_way(branch.lo, new_dim, leaf)
        if dim_coord >= branch.cut_coord:
            _update_scores_on_way(branch.hi, new_dim, leaf)


def chain_blocks(q_name: str, q_size: int, q_strand: str,
                 t_name: str, t_size: int,
                 blocks: list, connect_cost, gap_cost,
                 details=None) -> list[Chain]:
    """chainBlocks: chain scored blocks into maximal-scoring chains.

    blocks: list of [tS, tE, qS, qE, score] (score int, set by caller).
    connect_cost(a, b) / gap_cost(dq, dt) as in chainConnect.
    Returns chains sorted by preliminary score descending; block rows are
    shared into the returned chains.
    """
    if not blocks:
        return []
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        # leaf list: slAddHead over block list -> reversed; drop 0-length
        leaves = [_Leaf(cb=b, total_score=float(b[4]))
                  for b in blocks if b[0] != b[1]]
        leaves.reverse()
        # sort by tStart (stable, like kent slSort/mergesort)
        leaves.sort(key=lambda lf: lf.cb[0])
        t_list = leaves
        q_list = sorted(leaves, key=lambda lf: lf.cb[2])
        tree = _kd_build(q_list, t_list, 0)

        for leaf in t_list:
            pred, score = _best_predecessor(leaf, connect_cost, gap_cost, 0,
                                            tree, None, 0.0)
            if score > leaf.total_score:
                leaf.total_score = score
                leaf.best_pred = pred
            _update_scores_on_way(tree, 0, leaf)

        # peelChains: sort desc by total score (stable), trace predecessors
        by_total = sorted(t_list, key=lambda lf: -lf.total_score)
        chains: list[Chain] = []
        for leaf in by_total:
            if leaf.hit:
                continue
            if details is not None:
                # chainWriteHead at peel time: only the tip's ends are set
                # (chainBlock.c:349-356), score = totalScore, id = -1
                from ..formats.chain import format_score
                details.write(
                    f"chain {format_score(leaf.total_score)} {t_name} "
                    f"{t_size} + 0 {leaf.cb[1]} {q_name} {q_size} "
                    f"{q_strand} 0 {leaf.cb[3]} -1\n")
            rows = []
            lf = leaf
            while True:
                lf.hit = True
                rows.append(lf.cb)
                if details is not None:
                    b = lf.cb
                    details.write(f"{int(b[4])}\t{lf.total_score:f}\t"
                                  f"{b[0]}\t{b[2]}\t{b[3] - b[2]}\n")
                if lf.best_pred is None:
                    break
                if details is not None:
                    a = lf.best_pred.leaf.cb
                    b = lf.cb
                    details.write(f" gap {b[0] - a[1]}\t{b[2] - a[3]}\n")
                lf = lf.best_pred.leaf
                if lf.hit:
                    break
            rows.reverse()
            import numpy as np
            arr = np.array([r[:4] for r in rows], dtype=np.int64)
            chain = Chain(
                score=0.0, t_name=t_name, t_size=t_size,
                t_start=int(arr[0, 0]), t_end=int(arr[-1, 1]),
                q_name=q_name, q_size=q_size, q_strand=q_strand,
                q_start=int(arr[0, 2]), q_end=int(arr[-1, 3]),
                id=0, blocks=arr)
            chain._rows = rows  # keep scored rows for rescoring
            chains.append(chain)
        # chains were collected in peel order; C slAddHead+slReverse keeps
        # the same order.  Rescore with connect costs, then sort desc.
        for chain in chains:
            rows = chain._rows
            score = 0.0
            for i, r in enumerate(rows):
                score += r[4]
                if i > 0:
                    score -= connect_cost(rows[i - 1], r)
            chain.score = score
        chains.sort(key=lambda c: -c.score)
        return chains
    finally:
        sys.setrecursionlimit(old_limit)


def chain_blocks_arrays(q_name: str, q_size: int, q_strand: str,
                        t_name: str, t_size: int, rows: list,
                        q_codes, t_codes, lut, gap_calc,
                        details=None) -> list[Chain]:
    """chain_blocks over the standard cost model (substitution LUT +
    gapCalc), dispatching to the native C++ DP (native/chainblocks.cpp)
    when available - ~100x the python path on whole-genome inputs, same
    bytes."""
    from ..native import get_lib
    lib = get_lib()
    if details is not None and rows:
        # debugging path: the native DP doesn't emit details
        from .chain_connect import connect_cost as _cc, gap_cost as _gc
        import numpy as np
        lutx = np.asarray(lut)
        return chain_blocks(
            q_name, q_size, q_strand, t_name, t_size, rows,
            lambda a, b: _cc(a, b, q_codes, t_codes, lutx, gap_calc),
            lambda dq, dt: _gc(dq, dt, gap_calc), details=details)
    if lib is None or not rows:
        from .chain_connect import connect_cost as _cc, gap_cost as _gc
        import numpy as np
        lut = np.asarray(lut)
        return chain_blocks(
            q_name, q_size, q_strand, t_name, t_size, rows,
            lambda a, b: _cc(a, b, q_codes, t_codes, lut, gap_calc),
            lambda dq, dt: _gc(dq, dt, gap_calc))
    import ctypes

    import numpy as np
    blocks5 = np.ascontiguousarray(np.asarray(rows, np.int64))
    n = blocks5.shape[0]
    out_chain = np.empty(n, np.int64)
    out_pos = np.empty(n, np.int64)
    out_scores = np.empty(n, np.float64)
    lut64 = np.ascontiguousarray(np.asarray(lut), np.int64)
    qc = np.ascontiguousarray(q_codes)
    tc = np.ascontiguousarray(t_codes)
    g = gap_calc
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n_chains = lib.gat_chain_blocks(
        blocks5.ctypes.data_as(i64p), n,
        qc.ctypes.data_as(u8p), tc.ctypes.data_as(u8p),
        lut64.ctypes.data_as(i64p), lut64.shape[0],
        int(g.small_size),
        g.q_small.ctypes.data_as(i64p), g.t_small.ctypes.data_as(i64p),
        g.b_small.ctypes.data_as(i64p),
        g.long_pos.ctypes.data_as(i64p), g.long_pos.shape[0],
        np.ascontiguousarray(g.q_long).ctypes.data_as(f64p),
        np.ascontiguousarray(g.t_long).ctypes.data_as(f64p),
        np.ascontiguousarray(g.b_long).ctypes.data_as(f64p),
        out_chain.ctypes.data_as(i64p), out_pos.ctypes.data_as(i64p),
        out_scores.ctypes.data_as(f64p))

    import numpy as _np
    chains: list[Chain] = []
    order = _np.lexsort((out_pos, out_chain))
    order = order[out_chain[order] >= 0]
    bounds = _np.searchsorted(out_chain[order],
                              _np.arange(n_chains + 1))
    for c in range(int(n_chains)):
        idx = order[bounds[c]:bounds[c + 1]]
        crows = [rows[i] for i in idx.tolist()]
        arr = blocks5[idx][:, :4]
        chain = Chain(
            score=float(out_scores[c]), t_name=t_name, t_size=t_size,
            t_start=int(arr[0, 0]), t_end=int(arr[-1, 1]),
            q_name=q_name, q_size=q_size, q_strand=q_strand,
            q_start=int(arr[0, 2]), q_end=int(arr[-1, 3]),
            id=0, blocks=arr.copy())
        chain._rows = crows
        chains.append(chain)
    return chains
