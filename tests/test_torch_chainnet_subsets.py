"""chainNet -rescore's table path: the partial fills cut from the chain
table's arrays at once (ops/rescore.py subset_blocks) and scored by
TorchChainScorer.score_subsets in every mode, without python Chain objects.

subset_blocks is held to Chain.subset_on_t block for block; score_subsets
in window and pair mode on CPU tensors (the plain sums) to the fused native
gat_subset_scores on every job; the nets to one another in every mode and
through the python paths, with the counters saying which path cut the
fills.
"""

import io
import os

import numpy as np
import pytest

from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.device.genome import open_genome
from genomealignmenttools_tpu_torch.engines import chain_net as cn
from genomealignmenttools_tpu_torch.formats.chain import Chain, read_chains
from genomealignmenttools_tpu_torch.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu_torch.formats.scorematrix import \
    score_scheme_default
from genomealignmenttools_tpu_torch.native import get_lib
from genomealignmenttools_tpu_torch.native.chain_io import parse_chain_table
from genomealignmenttools_tpu_torch.ops.rescore import (
    TorchChainScorer, lut25_of, native_subset_scores, subset_blocks,
    table_row_code_ptrs)


def _chain(blocks, cid=1):
    b = np.asarray(blocks, np.int64).reshape(-1, 4)
    return Chain(score=1000.0, t_name="t", t_size=10 ** 6,
                 t_start=int(b[0, 0]), t_end=int(b[-1, 1]), q_name="q",
                 q_size=10 ** 6, q_strand="+", q_start=int(b[0, 2]),
                 q_end=int(b[-1, 3]), id=cid, blocks=b)


def _random_chain(rng, cid):
    n = int(rng.integers(1, 9))
    t, q = int(rng.integers(0, 50)), int(rng.integers(0, 50))
    rows = []
    for _ in range(n):
        size = int(rng.integers(1, 30))
        rows.append((t, t + size, q, q + size))
        t += size + int(rng.integers(1, 20))
        q += size + int(rng.integers(0, 20))
    return _chain(rows, cid)


def _arrays(chains):
    off = np.zeros(len(chains) + 1, np.int64)
    np.cumsum([c.n_blocks for c in chains], out=off[1:])
    return np.concatenate([c.blocks for c in chains]), off


def _assert_as_subset_on_t(chains, jobs):
    blocks, off = _arrays(chains)
    sub, sub_off, exists = subset_blocks(blocks, off, jobs)
    assert sub.dtype == np.int64 and sub.shape[1] == 4
    assert sub_off.shape == (len(jobs) + 1,) and exists.shape == (len(jobs),)
    for k, (row, lo, hi) in enumerate(jobs):
        want = chains[row].subset_on_t(lo, hi)
        got = sub[sub_off[k]:sub_off[k + 1]]
        assert bool(exists[k]) == (want is not None)
        assert np.array_equal(got, want.blocks if want is not None
                              else np.zeros((0, 4), np.int64))


ONE = [[100, 200, 1000, 1100]]
THREE = [[10, 20, 110, 120], [30, 50, 125, 145], [60, 90, 150, 180]]

CASES = {
    "a window inside one block": ([THREE], [(0, 35, 45)]),
    "a window in a gap": ([THREE], [(0, 20, 30), (0, 51, 59)]),
    "partial first and last blocks": ([THREE], [(0, 15, 70), (0, 12, 89)]),
    "a window over the whole chain": ([THREE], [(0, 0, 100), (0, 10, 90)]),
    "a window that touches a block's ends": ([THREE], [(0, 20, 60),
                                                       (0, 50, 61)]),
    "a single-block chain": ([ONE], [(0, 150, 160), (0, 50, 120),
                                     (0, 190, 300), (0, 0, 100),
                                     (0, 200, 300)]),
    "jobs on interleaved rows": ([THREE, ONE, THREE],
                                 [(2, 15, 70), (0, 35, 45), (1, 150, 160),
                                  (0, 15, 70), (2, 20, 30), (1, 0, 99)]),
    "zero jobs": ([THREE, ONE], []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_subset_blocks_is_subset_on_t(case):
    rows, jobs = CASES[case]
    _assert_as_subset_on_t([_chain(b, i) for i, b in enumerate(rows)], jobs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subset_blocks_on_random_chains(seed):
    rng = np.random.default_rng(seed)
    chains = [_random_chain(rng, i) for i in range(40)]
    jobs = []
    for _ in range(400):
        r = int(rng.integers(0, len(chains)))
        c = chains[r]
        lo = int(rng.integers(max(0, c.t_start - 5), c.t_end + 5))
        hi = int(rng.integers(lo + 1, c.t_end + 10))
        jobs.append((r, lo, hi))
    _assert_as_subset_on_t(chains, jobs)


# --- score_subsets against the fused native pass ------------------------

@pytest.fixture(scope="module")
def pair12(tmp_path_factory):
    from benchmark.workloads import cleaner
    return cleaner.generate(2 ** 32 + 5, {"n_scenarios": 12, "n_bulk": 60},
                            str(tmp_path_factory.mktemp("pair12")))


def _inputs(name, pair12, fixtures_dir):
    """(chain file, target sizes, query sizes, target 2bit, query 2bit)."""
    if name == "pair12":
        p = pair12["paths"]
        return p["chain"], p["t_sizes"], p["q_sizes"], p["t2bit"], p["q2bit"]
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    return (f("synthetic.scored.sorted.chain"), f("target.chrom.sizes"),
            f("query.chrom.sizes"), f("target.2bit"), f("query.2bit"))


def _jobs(table, sel, rng):
    """Windows over each selected row's target range: inside it, across
    either end, over all of it and past it."""
    jobs = []
    for k, i in enumerate(sel.tolist()):
        ts, te = int(table.header[i, 1]), int(table.header[i, 2])
        for _ in range(4):
            lo = int(rng.integers(max(0, ts - 50), te))
            jobs.append((k, lo, int(rng.integers(lo + 1, te + 50))))
        jobs.append((k, ts, te))
    return np.array(jobs, np.int64)


@pytest.mark.parametrize("mode,combine", [("auto", None), ("pair", None),
                                          ("pair", "device")])
@pytest.mark.parametrize("name", ["pair12", "synthetic.scored.sorted"])
def test_score_subsets_equals_native_subset_scores(name, mode, combine,
                                                   pair12, fixtures_dir,
                                                   monkeypatch):
    if combine is None:
        monkeypatch.delenv("GAT_COMBINE", raising=False)
    else:
        monkeypatch.setenv("GAT_COMBINE", combine)
    chain, _, _, t2bit, q2bit = _inputs(name, pair12, fixtures_dir)
    with open(chain, "rb") as fh:
        table = parse_chain_table(fh.read())
    rng = np.random.default_rng(7)
    sel = np.sort(rng.choice(len(table), size=min(len(table), 60),
                             replace=False))
    blocks, block_off = cn._gather_blocks(table, sel)
    jobs = _jobs(table, sel, rng)
    scheme, gap_calc = score_scheme_default(), gap_calc_from_file("loose")
    t_genome, q_genome = open_genome(t2bit), open_genome(q2bit)
    t_ptrs, q_ptrs, keepalive = table_row_code_ptrs(table, sel, t_genome,
                                                    q_genome)
    want = native_subset_scores(get_lib(), blocks, block_off, t_ptrs, q_ptrs,
                                lut25_of(scheme.lut), gap_calc, jobs)
    del keepalive
    scorer = TorchChainScorer(scheme, gap_calc, t_genome, q_genome,
                              device="cpu", mode=mode)
    got = scorer.score_subsets(table, sel, blocks, block_off, jobs)
    assert got.dtype == np.int64 and got.shape == (len(jobs), 4)
    assert (want[:, 3] == 0).any() and (want[:, 3] != 0).any()
    assert np.array_equal(got, want)
    assert scorer.score_subsets(table, sel, blocks, block_off,
                                jobs[:0]).shape == (0, 4)


# --- the nets, and which path cut the fills -----------------------------

def _net(inputs, chains=None, **kw):
    chain, t_sizes, q_sizes, t2bit, q2bit = inputs
    t_out, q_out = io.StringIO(), io.StringIO()
    cn.chain_net(chain if chains is None else chains, t_sizes, q_sizes,
                 t_out, q_out, min_space=1, rescore=True, t_2bit=t2bit,
                 q_2bit=q2bit, linear_gap="loose", **kw)
    return t_out.getvalue(), q_out.getvalue()


def _partial_fills(t_net, chains):
    span = {c.id: (c.t_start, c.t_end) for c in chains}
    fills = [ln.split() for ln in t_net.splitlines()
             if ln.lstrip().startswith("fill ")]
    return sum(not (int(f[1]) <= span[int(f[8])][0]
                    and int(f[1]) + int(f[2]) >= span[int(f[8])][1])
               for f in fills)


@pytest.mark.parametrize("name", ["pair12", "synthetic.scored.sorted"])
def test_nets_and_counters_on_each_path(name, pair12, fixtures_dir,
                                        monkeypatch):
    """The chain file takes the table path in window, pair and host-native
    mode; a list of Chain and the python Netter take the per-fill cut.
    Every net is the same bytes."""
    inputs = _inputs(name, pair12, fixtures_dir)
    chains = read_chains(inputs[0])
    monkeypatch.delenv("GAT_COMBINE", raising=False)
    runs = {}
    for path, mode, as_list in [("window", "auto", False),
                                ("pair", "pair", False),
                                ("hostnative", "hostnative", False),
                                ("window, Chain list", "auto", True),
                                ("pair, Chain list", "pair", True)]:
        monkeypatch.setenv("GAT_RESCORE", mode)
        perf_reset()
        runs[path] = _net(inputs, chains if as_list else None, device="cpu")
        partial = _partial_fills(runs[path][0], chains)
        assert partial > 0
        assert PERF["chainnet_rescored_fills"] == partial
        table, python = ((0, partial) if as_list else (partial, 0))
        assert PERF["chainnet_subsets_table"] == table, path
        assert PERF["chainnet_subsets_python"] == python, path
    monkeypatch.setenv("GAT_RESCORE", "auto")
    monkeypatch.setattr(cn, "_native_net_tree", lambda *a, **k: None)
    monkeypatch.setattr(cn, "_native_net_tree_table", lambda *a, **k: None)
    perf_reset()
    runs["python Netter"] = _net(inputs, device="cpu")
    assert PERF["chainnet_subsets_table"] == 0
    assert PERF["chainnet_subsets_python"] == PERF["chainnet_rescored_fills"]
    assert PERF["chainnet_rescored_fills"] == _partial_fills(
        runs["python Netter"][0], chains)
    for path, nets in runs.items():
        assert nets == runs["window"], path
