"""chainCleaner's prescore on the table path: under a device scorer every
pending break's sub-chains are cut from the row chains' arrays at once and
scored by TorchChainScorer.score_subsets (ChainRows standing in for the
chain table), without a python Chain a job; a scorer with only
score_chains cuts them one by one by Chain.subset_on_t.

Every cache entry the prescore writes is held to Chain.subset_on_t and the
host scorer's score_arrays, in window mode, int8 pair mode and pair mode
with the device combine; PERF's cleaner_prescore_* counters say which path
cut the jobs; the cleaned chains and BED stay the goldens' bytes.
"""

import os

import numpy as np
import pytest

from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.device.genome import open_genome
from genomealignmenttools_tpu_torch.engines import chain_cleaner as cc
from genomealignmenttools_tpu_torch.engines.scoring import (
    ChainScorer, chain_global_score, chain_local_score)
from genomealignmenttools_tpu_torch.formats.chain import Chain
from genomealignmenttools_tpu_torch.formats.gapcalc import gap_calc_from_file
from genomealignmenttools_tpu_torch.formats.scorematrix import \
    score_scheme_default
from genomealignmenttools_tpu_torch.ops.rescore import (ChainRows,
                                                        TorchChainScorer)

MODES = {
    "window": {"GAT_RESCORE": None, "GAT_COMBINE": None},
    "pair": {"GAT_RESCORE": "pair", "GAT_COMBINE": None},
    "pair, device combine": {"GAT_RESCORE": "pair", "GAT_COMBINE": "device"},
}


def _set_mode(monkeypatch, mode):
    monkeypatch.delenv("GAT_PAIR_TILES", raising=False)
    for name, value in MODES[mode].items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


@pytest.fixture(scope="module")
def scoring(fixtures_dir):
    """(scheme, gap_calc, t_genome, q_genome) of the fixtures' genomes."""
    return (score_scheme_default(), gap_calc_from_file("loose"),
            open_genome(os.path.join(fixtures_dir, "target.2bit")),
            open_genome(os.path.join(fixtures_dir, "query.2bit")))


class ChainsOnly:
    """A scorer with score_chains and score_arrays alone (as
    parallel/mesh.py's ShardedChainScorer has no score_subsets)."""

    def __init__(self, scorer):
        self._scorer = scorer

    def score_chains(self, chains):
        return self._scorer.score_chains(chains)

    def score_arrays(self, chain):
        return self._scorer.score_arrays(chain)


def _oracle(chain, start, end, host):
    """(global, local, ali, exists) of chain.subset_on_t(start, end)."""
    sub = chain.subset_on_t(start, end)
    if sub is None:
        return (0.0, 0.0, 0, False)
    bs, gc = host.score_arrays(sub)
    return (float(chain_global_score(bs, gc)),
            float(chain_local_score(bs, gc)),
            int((sub.blocks[:, 1] - sub.blocks[:, 0]).sum()), True)


def _expected_keys(cleaner, allowed):
    """The (chain id, start, end) of every job, in the loop's order, once."""
    keys = []
    for key, break_list in cleaner.break_hash.el_list_order():
        if allowed is not None and key not in allowed:
            continue
        for b in break_list:
            for cid, s, e in ((b.parent_chain_id, b.suspect_start,
                               b.suspect_end),
                              (b.chain_id, b.l_fill_start, b.r_fill_end),
                              (b.chain_id, b.l_fill_start, b.suspect_end),
                              (b.chain_id, b.suspect_start, b.r_fill_end)):
                if cid in cleaner.chains and (cid, s, e) not in keys:
                    keys.append((cid, s, e))
    return keys


def _assert_cache_is_oracle(cleaner, host, keys):
    assert len(keys) == len(set(keys))
    assert set(cleaner._sub_cache) == set(keys)
    for (cid, s, e), entry in cleaner._sub_cache.items():
        assert entry[4] == cleaner._seq
        assert entry[:4] == _oracle(cleaner.chains[cid], s, e, host), \
            (cid, s, e)


# --- planted breaks, one named case each ---------------------------------

SIZES = {"chrA": 1_000_000, "chrB": 200_000, "chrQ1": 2_000_000,
         "chrQ2": 150_000}     # tests/fixtures/*.chrom.sizes


def _chain(cid, blocks, t_name="chrA", q_name="chrQ1", strand="+"):
    b = np.asarray(blocks, np.int64).reshape(-1, 4)
    return Chain(score=100000.0, t_name=t_name, t_size=SIZES[t_name],
                 t_start=int(b[0, 0]), t_end=int(b[-1, 1]), q_name=q_name,
                 q_size=SIZES[q_name], q_strand=strand,
                 q_start=int(b[:, 2].min()), q_end=int(b[:, 3].max()),
                 id=cid, blocks=b)


# a breaking chain: two anchors around a weak suspect block at 30,000
BREAKING = [[10_000, 11_000, 110_000, 111_000],
            [30_000, 30_250, 130_000, 130_250],
            [50_000, 51_000, 150_000, 151_000]]
# a broken chain filling both of the breaking chain's gaps
BROKEN = [[12_000, 12_800, 212_000, 212_800],
          [20_000, 20_500, 220_000, 220_500],
          [40_000, 40_600, 240_000, 240_600],
          [45_000, 45_900, 245_000, 245_900]]


def _brk(child, parent, lfs=12_000, rfe=46_000, suspect=(29_000, 31_000)):
    lge, rgs = suspect
    return cc.BreakInfo(1, child, parent, "chrA", lfs, lfs + 100,
                        rfe - 100, rfe, lfs + 100, lge, rgs, rfe - 100)


def _case(name):
    """(chains, {parent key: [BreakInfo]}, allowed_parents)."""
    breaking, broken = _chain(1, BREAKING), _chain(2, BROKEN)
    if name == "a job that cuts no block":
        # the suspect range lies in a gap of the breaking chain
        return [breaking, broken], {"1": [_brk(2, 1, suspect=(31_000,
                                                             32_000))]}, None
    if name == "a job that covers the whole chain":
        # the fill range [l_fill_start, r_fill_end) holds all of the broken
        # chain, which subset_on_t returns whole
        return [breaking, broken], {"1": [_brk(2, 1, lfs=11_500,
                                              rfe=47_000)]}, None
    if name == "a duplicated job":
        # two breaks of one broken chain with the same fill range: its
        # fill job is queued once
        return [breaking, broken], {"1": [_brk(2, 1),
                                          _brk(2, 1, suspect=(29_500,
                                                              30_100))]}, None
    if name == "a minus-strand chain":
        return [breaking, _chain(2, BROKEN, strand="-")], \
            {"1": [_brk(2, 1)]}, None
    if name == "allowed_parents takes a subset of the lists":
        other = _chain(3, [[b[0] + 100_000, b[1] + 100_000,
                            b[2] + 300_000, b[3] + 300_000]
                           for b in BREAKING])
        child = _chain(4, [[b[0] + 100_000, b[1] + 100_000,
                            b[2] + 400_000, b[3] + 400_000]
                           for b in BROKEN])
        far = _brk(4, 3, lfs=112_000, rfe=146_000,
                   suspect=(129_000, 131_000))
        return [breaking, broken, other, child], \
            {"1": [_brk(2, 1)], "3": [far]}, {"3"}
    if name == "two genome pairs, both strands":
        child = _chain(4, [[b[0], b[1], b[2] - 200_000, b[3] - 200_000]
                           for b in BROKEN], q_name="chrQ2", strand="-")
        return [breaking, broken, child], \
            {"1": [_brk(2, 1), _brk(4, 1, lfs=12_500, rfe=45_500)]}, None
    raise KeyError(name)


CASES = ["a job that cuts no block", "a job that covers the whole chain",
         "a duplicated job", "a minus-strand chain",
         "allowed_parents takes a subset of the lists",
         "two genome pairs, both strands"]


def _cleaner(scorer, host, chains, lists):
    cleaner = cc.ChainCleaner(scorer, host_scorer=host)
    for c in chains:
        cleaner.chains[c.id] = c
    for key, breaks in lists.items():
        cleaner.break_hash.add(key, breaks)
    return cleaner


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", CASES)
def test_prescore_table_path_is_subset_on_t(case, mode, scoring,
                                            monkeypatch):
    _set_mode(monkeypatch, mode)
    scheme, gap_calc, t_genome, q_genome = scoring
    host = ChainScorer(scheme, gap_calc, t_genome, q_genome)
    scorer = TorchChainScorer(scheme, gap_calc, t_genome, q_genome,
                              device="cpu")
    chains, lists, allowed = _case(case)
    cleaner = _cleaner(scorer, host, chains, lists)
    keys = _expected_keys(cleaner, allowed)
    perf_reset()
    cleaner._prescore_breaks(allowed)
    assert PERF["cleaner_prescore_table"] == len(keys)
    assert PERF["cleaner_prescore_python"] == 0
    _assert_cache_is_oracle(cleaner, host, keys)
    # as many device passes as score_chains makes over the cut sub-chains
    dispatches = PERF["dispatches"]
    chains, lists, allowed = _case(case)
    perf_reset()
    _cleaner(ChainsOnly(scorer), host, chains, lists)._prescore_breaks(
        allowed)
    assert PERF["cleaner_prescore_python"] == len(keys)
    assert dispatches == PERF["dispatches"] >= 1
    exists = [cleaner._sub_cache[k][3] for k in keys]
    if case == "a job that cuts no block":
        assert not exists[0] and all(exists[1:])
    if case == "a job that covers the whole chain":
        full = chains[1]
        assert full.subset_on_t(*keys[1][1:]) is full
        assert cleaner._sub_cache[keys[1]][2] == int(
            (full.blocks[:, 1] - full.blocks[:, 0]).sum())
    if case == "a duplicated job":
        assert len(keys) == 7       # 2 breaks x 4 jobs, one fill job shared
    if case == "allowed_parents takes a subset of the lists":
        assert {k[0] for k in keys} == {3, 4}


@pytest.mark.parametrize("mode", list(MODES))
def test_prescore_without_jobs(mode, scoring, monkeypatch):
    """Breaks whose chains are not stored, and lists allowed_parents
    leaves out, queue nothing: no entry, no device pass."""
    _set_mode(monkeypatch, mode)
    scheme, gap_calc, t_genome, q_genome = scoring
    host = ChainScorer(scheme, gap_calc, t_genome, q_genome)
    scorer = TorchChainScorer(scheme, gap_calc, t_genome, q_genome,
                              device="cpu")
    for chains, allowed in (([], None), ([_chain(1, BREAKING)], {"3"})):
        cleaner = _cleaner(scorer, host, chains, {"1": [_brk(2, 1)]})
        perf_reset()
        cleaner._prescore_breaks(allowed)
        assert cleaner._sub_cache == {}
        assert PERF["cleaner_prescore_table"] == 0
        assert PERF["dispatches"] == 0


@pytest.mark.parametrize("case", CASES)
def test_prescore_score_chains_only_cuts_by_subset_on_t(case, scoring,
                                                        monkeypatch):
    _set_mode(monkeypatch, "window")
    scheme, gap_calc, t_genome, q_genome = scoring
    host = ChainScorer(scheme, gap_calc, t_genome, q_genome)
    scorer = ChainsOnly(TorchChainScorer(scheme, gap_calc, t_genome,
                                         q_genome, device="cpu"))
    chains, lists, allowed = _case(case)
    cleaner = _cleaner(scorer, host, chains, lists)
    keys = _expected_keys(cleaner, allowed)
    perf_reset()
    cleaner._prescore_breaks(allowed)
    assert PERF["cleaner_prescore_python"] == len(keys)
    assert PERF["cleaner_prescore_table"] == 0
    _assert_cache_is_oracle(cleaner, host, keys)


def test_chain_rows_are_what_score_subsets_reads():
    chains = [_chain(1, BREAKING), _chain(2, BROKEN, q_name="chrQ2",
                                          strand="-"),
              _chain(3, BROKEN, t_name="chrB")]
    rows = ChainRows(chains)
    (t_ids, t_names), (q_ids, q_names) = rows.names_factorized()
    assert t_ids.dtype == np.int32 and q_ids.dtype == np.int32
    assert [t_names[i] for i in t_ids] == ["chrA", "chrA", "chrB"]
    assert [q_names[i] for i in q_ids] == ["chrQ1", "chrQ2", "chrQ1"]
    assert len(t_names) == 2 and len(q_names) == 2
    assert rows.strands.tolist() == [ord("+"), ord("-"), ord("+")]
    empty = ChainRows([])
    assert empty.strands.shape == (0,)
    assert empty.names_factorized()[0][0].shape == (0,)


# --- whole runs: the goldens, and the cache before the loop -------------

def _run(src, fixtures_dir, out, **kw):
    f = lambda n: os.path.join(fixtures_dir, n)  # noqa: E731
    cc.clean_chains(src, f("target.2bit"), f("query.2bit"),
                    out + ".chain", out + ".bed",
                    t_sizes=f("target.chrom.sizes"),
                    q_sizes=f("query.chrom.sizes"), linear_gap="loose",
                    **kw)
    with open(out + ".chain", "rb") as a, open(out + ".bed", "rb") as b:
        return a.read(), b.read()


@pytest.fixture
def prescored(monkeypatch):
    """Each cleaner's prescore, as it left the cache before the loop:
    (number of jobs, the entries, the oracle's entries), the oracle being
    the host scorer on subset_on_t of the chains as they were then."""
    seen = []
    prescore = cc.ChainCleaner._prescore_breaks

    def spy(self, allowed_parents=None):
        prescore(self, allowed_parents)
        keys = _expected_keys(self, allowed_parents)
        seen.append((len(keys), dict(self._sub_cache),
                     {(cid, s, e): _oracle(self.chains[cid], s, e,
                                           self.host_scorer) + (self._seq,)
                      for cid, s, e in keys}))

    monkeypatch.setattr(cc.ChainCleaner, "_prescore_breaks", spy)
    return seen


def _check_prescored(prescored):
    assert len(prescored) == 1
    n_jobs, cache, oracle = prescored[0]
    assert n_jobs > 0 and cache == oracle
    return n_jobs


@pytest.mark.parametrize("mode", list(MODES))
def test_goldens_through_the_table_path(mode, fixtures_dir, golden_dir,
                                        tmp_path, monkeypatch, prescored):
    """The fixtures' chainCleaner through the python break loop (device
    scorers never take the native one) with the table prescore: the golden
    bytes, every prescored entry the oracle's, every job on the table."""
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    set_verbosity(0)
    _set_mode(monkeypatch, mode)
    perf_reset()
    got = _run(os.path.join(fixtures_dir, "synthetic.scored.sorted.chain"),
               fixtures_dir, str(tmp_path / "c"), device="cpu")
    n_jobs = _check_prescored(prescored)
    assert PERF["cleaner_prescore_table"] == n_jobs
    assert PERF["cleaner_prescore_python"] == 0
    with open(os.path.join(golden_dir, "chainCleaner.out.chain"), "rb") as a, \
            open(os.path.join(golden_dir,
                              "chainCleaner.removedSuspects.bed"), "rb") as b:
        assert got == (a.read(), b.read())


def test_goldens_through_score_chains_only(fixtures_dir, golden_dir,
                                           tmp_path, monkeypatch, prescored):
    """A scorer with only score_chains: the per-job subset_on_t path,
    counted there, gives the same golden bytes."""
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    set_verbosity(0)
    _set_mode(monkeypatch, "window")
    perf_reset()

    def factory(*args):
        return ChainsOnly(TorchChainScorer(*args, device="cpu"))

    got = _run(os.path.join(fixtures_dir, "synthetic.scored.sorted.chain"),
               fixtures_dir, str(tmp_path / "c"), scorer_factory=factory)
    n_jobs = _check_prescored(prescored)
    assert PERF["cleaner_prescore_python"] == n_jobs
    assert PERF["cleaner_prescore_table"] == 0
    with open(os.path.join(golden_dir, "chainCleaner.out.chain"), "rb") as a, \
            open(os.path.join(golden_dir,
                              "chainCleaner.removedSuspects.bed"), "rb") as b:
        assert got == (a.read(), b.read())


@pytest.fixture(scope="module")
def small_workload(tmp_path_factory):
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_cleaner_workload
    return build_cleaner_workload(str(tmp_path_factory.mktemp("w")),
                                  n_scenarios=20, n_bulk=200)


@pytest.mark.parametrize("mode", list(MODES))
def test_workload_through_the_table_path(mode, small_workload, tmp_path,
                                         monkeypatch, prescored):
    """build_cleaner_workload(20, 200): the table prescore's entries are the
    oracle's and the output is the host-native run's bytes."""
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    set_verbosity(0)
    m = small_workload

    def run(out, **kw):
        cc.clean_chains(m["chain"], m["t2bit"], m["q2bit"], out + ".chain",
                        out + ".bed", t_sizes=m["t_sizes"],
                        q_sizes=m["q_sizes"], linear_gap="loose", **kw)
        with open(out + ".chain", "rb") as a, open(out + ".bed", "rb") as b:
            return a.read(), b.read()

    monkeypatch.setenv("GAT_RESCORE", "hostnative")
    want = run(str(tmp_path / "h"))
    prescored.clear()       # the host-native run takes the native loop
    _set_mode(monkeypatch, mode)
    perf_reset()
    got = run(str(tmp_path / "c"), device="cpu")
    n_jobs = _check_prescored(prescored)
    assert n_jobs >= 4 * 20
    assert PERF["cleaner_prescore_table"] == n_jobs
    assert PERF["cleaner_prescore_python"] == 0
    assert got == want
    assert want[1]          # suspects were removed
