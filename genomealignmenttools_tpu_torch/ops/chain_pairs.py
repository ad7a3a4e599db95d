"""axtChain's chainPair and chainSort over many small sequence pairs in one
native call: the chaining stage of RepeatFiller's gaps.

`chain_gap_hsps` hands every gap of a chunk to `gat_chain_pairs`
(native/chainpairs.cpp), which for each gap scores the HSP rows, chains them
with the kd-tree DP (`gat_chain_blocks`), repairs each chain's overlaps and
merges its abutting blocks, rescores it exactly, drops it under the minimum
score and sorts the rest by descending score, the gaps spread over the
native library's threads.  The result is what
`engines/repeat_filler._gap_job_chains` gives for each gap, chain by chain,
at any thread count; that per-gap Python path stays the fallback where the
native library is absent (`GAT_NATIVE=0`) and for rows the call refuses.
"""

from __future__ import annotations

import ctypes
from itertools import chain as _iter_chain

import numpy as np

from ..formats.chain import Chain
from ..native import get_lib

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


class _Result(ctypes.Structure):
    _fields_ = [("n_chains", ctypes.c_int64),
                ("n_blocks", ctypes.c_int64),
                ("pair_off", _i64p),
                ("scores", _i64p),
                ("chain_off", _i64p),
                ("blocks", _i64p),
                ("error", ctypes.c_char * 256)]


def _bind(lib):
    fn = lib.gat_chain_pairs
    fn.restype = ctypes.POINTER(_Result)
    fn.argtypes = [_i64p, _i64p, ctypes.c_int64,
                   ctypes.c_void_p, _i64p, ctypes.c_void_p, _i64p,
                   _i64p, ctypes.c_int64, ctypes.c_int64,
                   _i64p, _i64p, _i64p, _i64p, ctypes.c_int64,
                   _f64p, _f64p, _f64p, ctypes.c_double, ctypes.c_int]
    lib.gat_chain_pairs_free.restype = None
    lib.gat_chain_pairs_free.argtypes = [ctypes.POINTER(_Result)]
    return fn


def chain_gap_hsps(jobs, hsps_all, ctxs, scheme, gap_calc,
                   min_score: float, n_threads: int = 0
                   ) -> list[list[Chain]] | None:
    """Each gap's mini-chains, best first, as `_gap_job_chains` makes them.

    jobs: the gaps (`t_name`, `q_name`, `q_strand`); hsps_all: each gap's
    HSP rows ([tS, tE, qS, qE, ...]); ctxs: each gap's (t_codes, q_codes,
    t_size, q_size), q_codes on the gap's strand.  n_threads 0 takes the
    native library's count (GAT_THREADS).  None where the native library
    is absent or refuses a gap's rows: the caller then chains in Python."""
    lib = get_lib()
    if lib is None:
        return None
    fn = _bind(lib)
    n = len(jobs)
    counts = np.fromiter((len(h) for h in hsps_all), np.int64, count=n)
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_off[1:])
    rows4 = np.fromiter(
        _iter_chain.from_iterable(h[:4] for hsps in hsps_all for h in hsps),
        np.int64, count=4 * int(row_off[-1])).reshape(-1, 4)
    t_arrs = [np.ascontiguousarray(c[0], np.uint8) for c in ctxs]
    q_arrs = [np.ascontiguousarray(c[1], np.uint8) for c in ctxs]
    t_ptrs = np.array([a.ctypes.data for a in t_arrs], np.uintp)
    q_ptrs = np.array([a.ctypes.data for a in q_arrs], np.uintp)
    t_lens = np.array([a.shape[0] for a in t_arrs], np.int64)
    q_lens = np.array([a.shape[0] for a in q_arrs], np.int64)
    lut = np.ascontiguousarray(scheme.lut, np.int64)
    g = gap_calc
    tables = [np.ascontiguousarray(a, dt) for a, dt in (
        (g.q_small, np.int64), (g.t_small, np.int64), (g.b_small, np.int64),
        (g.long_pos, np.int64), (g.q_long, np.float64),
        (g.t_long, np.float64), (g.b_long, np.float64))]
    q_small, t_small, b_small, long_pos, q_long, t_long, b_long = tables
    res_p = fn(rows4.ctypes.data_as(_i64p), row_off.ctypes.data_as(_i64p), n,
               t_ptrs.ctypes.data, t_lens.ctypes.data_as(_i64p),
               q_ptrs.ctypes.data, q_lens.ctypes.data_as(_i64p),
               lut.ctypes.data_as(_i64p), lut.shape[0], int(g.small_size),
               q_small.ctypes.data_as(_i64p), t_small.ctypes.data_as(_i64p),
               b_small.ctypes.data_as(_i64p), long_pos.ctypes.data_as(_i64p),
               long_pos.shape[0], q_long.ctypes.data_as(_f64p),
               t_long.ctypes.data_as(_f64p), b_long.ctypes.data_as(_f64p),
               float(min_score), int(n_threads))
    try:
        res = res_p.contents
        if res.error:
            return None
        n_chains, n_blocks = int(res.n_chains), int(res.n_blocks)
        pair_off = np.ctypeslib.as_array(res.pair_off, (n + 1,)).tolist()
        if n_chains == 0:
            return [[] for _ in range(n)]
        scores = np.ctypeslib.as_array(res.scores, (n_chains,)).tolist()
        chain_off = np.ctypeslib.as_array(res.chain_off,
                                          (n_chains + 1,)).copy()
        blocks = np.ctypeslib.as_array(res.blocks, (n_blocks, 4)).copy()
    finally:
        lib.gat_chain_pairs_free(res_p)
    los, his = chain_off[:-1].tolist(), chain_off[1:].tolist()
    t_starts = blocks[chain_off[:-1], 0].tolist()
    q_starts = blocks[chain_off[:-1], 2].tolist()
    t_ends = blocks[chain_off[1:] - 1, 1].tolist()
    q_ends = blocks[chain_off[1:] - 1, 3].tolist()
    out = []
    for k, (job, ctx) in enumerate(zip(jobs, ctxs)):
        t_size, q_size = ctx[2], ctx[3]
        out.append([
            Chain(score=float(scores[c]), t_name=job.t_name, t_size=t_size,
                  t_start=t_starts[c], t_end=t_ends[c], q_name=job.q_name,
                  q_size=q_size, q_strand=job.q_strand,
                  q_start=q_starts[c], q_end=q_ends[c], id=0,
                  blocks=blocks[los[c]:his[c]])
            for c in range(pair_off[k], pair_off[k + 1])])
    return out
