"""Port twins of the reference's gap-filling tests:
tests/test_planted_alignment.py (the planted golden,
tests/golden/planted_cases.json), test_repeat_filler.py and the patchChain
tests of test_drivers.py.

Each feeds the reference test's inputs to the port, on the CPU: the port's
GapAligner(device="cpu"), the port's CLI (RepeatFiller, patchChain with
-device=cpu) where the reference test's options are the CLI's, else the
port's engine at the same relative path with device="cpu".  Each checks what
the reference test checks, against construction truth or the golden, and
that the port's band batch ran (PERF["band_problems"] moves) wherever the
reference's aligner reaches its band DP.

Not twinned here: test_repeat_filler.py::test_quirks_mode_matches_reference
(tests/test_torch_gap_fill.py holds the RepeatFiller golden through the
port's engine and CLI).
"""

import io
import os
import subprocess

import numpy as np
import pytest
import torch

import golden_cases as gc
from genomealignmenttools_tpu_torch.cli.main import main as port_main
from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.engines import repeat_filler as rf
from genomealignmenttools_tpu_torch.engines.drivers import patch_chain
from genomealignmenttools_tpu_torch.formats.chain import (Chain, read_chains,
                                                          write_chains)
from genomealignmenttools_tpu_torch.formats.psl import read_psls
from genomealignmenttools_tpu_torch.formats.scorematrix import \
    score_scheme_default
from genomealignmenttools_tpu_torch.formats.twobit import write_twobit
from genomealignmenttools_tpu_torch.ops.seed_extend import GapAligner

PLANTED = gc.planted_cases()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain band DP is thousands of small torch ops; under the
    parallel test runner, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _aligner(**kw):
    sch = score_scheme_default()
    args = dict(seed_len=10, hsp_threshold=1500, gapped_threshold=2000,
                gap_open=sch.gap_open, gap_extend=sch.gap_extend,
                char_matrix=sch.char_matrix(), device="cpu")
    args.update(kw)
    return GapAligner(sch.lut, **args)


# --- tests/test_planted_alignment.py ----------------------------------------

@pytest.mark.parametrize("case", PLANTED, ids=lambda c: c["spec"]["name"])
def test_planted_recovery(case):
    t, q, _ = gc.build_planted(case["spec"]["name"])
    perf_reset()
    got = _aligner().align(t, q, 0, t.shape[0], 0, q.shape[0])
    assert gc.planted_recovery_problem(case["spec"]["name"],
                                       case["planted_blocks"], got) is None
    # the inverted copy gives no HSP on the chain's strand, so no problem
    assert (PERF["band_problems"] > 0) == bool(got)


def test_planted_scores_match_construction():
    """The aligner's blocks score exactly what the planted alignment scores
    (LUT sums minus affine gaps, computed from the construction)."""
    case = gc.planted_case("small_indels_high_identity")
    t, q, _ = gc.build_planted("small_indels_high_identity")
    sch = score_scheme_default()
    lut = np.asarray(sch.lut, np.int64)

    def total(blocks):
        blocks = sorted(blocks, key=lambda b: b[0])
        s = 0
        for i, (ts, te, qs, qe) in enumerate(b[:4] for b in blocks):
            s += int(lut[q[qs:qe], t[ts:te]].sum())
            if i + 1 < len(blocks):
                nts, _, nqs, _ = blocks[i + 1][:4]
                s -= sch.gap_open + sch.gap_extend * max(nts - te, nqs - qe)
        return s
    got = _aligner().align(t, q, 0, t.shape[0], 0, q.shape[0])
    assert total(got) == total(case["planted_blocks"])


@pytest.mark.parametrize("case", sorted(gc.PLANTED_GAPS))
def test_planted_gap_end_to_end(tmp_path, case):
    """A chain whose gap spans a planted case, through the port's
    RepeatFiller CLI: the splice is what construction truth demands."""
    chain, t2, q2, planted = gc.planted_gap_inputs(gc.PLANTED_GAPS[case],
                                                   str(tmp_path))
    out = str(tmp_path / "out.chain")
    perf_reset()
    assert port_main(["RepeatFiller", "-c", chain, "-T2", t2, "-Q2", q2,
                      "-o", out, "-device=cpu"]) == 0
    assert PERF["band_problems"] > 0
    with open(out) as fh:
        assert gc.planted_gap_problem(case, chain, fh.read(), planted) is None


def _seed_codes_with_mask(t, spec):
    t_seed = t.copy()
    for a, b in spec.get("t_softmask", []):
        t_seed[a:b] = 4
    return t_seed


def test_softmask_boundary_masked_seeding_recovers():
    case = gc.planted_case("softmask_seed_boundary")
    t, q, _ = gc.build_planted("softmask_seed_boundary")
    planted = gc.merge_abutting(case["planted_blocks"])
    al = _aligner()
    for t_seed in (None, _seed_codes_with_mask(t, case["spec"])):
        got = al.align(t, q, 0, t.shape[0], 0, q.shape[0],
                       t_seed_codes=t_seed)
        got4 = gc.merge_abutting(sorted([b[:4] for b in got]))
        assert gc.on_target(got4, planted) == planted, t_seed is None


def test_softmask_full_copy_requires_unmask():
    case = gc.planted_case("softmask_full_copy")
    t, q, _ = gc.build_planted("softmask_full_copy")
    planted = gc.merge_abutting(case["planted_blocks"])
    al = _aligner()
    masked = al.align(t, q, 0, t.shape[0], 0, q.shape[0],
                      t_seed_codes=_seed_codes_with_mask(t, case["spec"]))
    assert gc.on_target(masked, planted) == []
    unmasked = al.align(t, q, 0, t.shape[0], 0, q.shape[0])
    got4 = gc.merge_abutting(sorted([b[:4] for b in unmasked]))
    assert gc.on_target(got4, planted) == planted


# --- tests/test_repeat_filler.py --------------------------------------------

def _rf_args(fix):
    return ["-c", os.path.join(fix, "repeatfiller_input.chain"),
            "-T2", os.path.join(fix, "target.2bit"),
            "-Q2", os.path.join(fix, "query.2bit")]


def _rf_engine(fix, **kw):
    out = io.StringIO()
    rf.repeat_filler(os.path.join(fix, "repeatfiller_input.chain"),
                     os.path.join(fix, "target.2bit"),
                     os.path.join(fix, "query.2bit"), out, device="cpu",
                     **kw)
    return out.getvalue()


def test_repeat_filler_clean_mode_fills_gaps_and_parses(fixtures_dir,
                                                        tmp_path):
    out = str(tmp_path / "out.chain")
    perf_reset()
    assert port_main(["RepeatFiller", *_rf_args(fixtures_dir), "-o", out,
                      "-device=cpu"]) == 0
    assert PERF["band_problems"] > 0
    chains = read_chains(out)
    orig = read_chains(os.path.join(fixtures_dir,
                                    "repeatfiller_input.chain"))
    assert len(chains) == len(orig) == 2
    for c, o in zip(chains, orig):
        b = c.blocks
        assert (b[1:, 0] >= b[:-1, 1]).all()
        assert (b[1:, 2] >= b[:-1, 3]).all()
        assert (c.t_start, c.t_end) == (o.t_start, o.t_end)
        assert c.n_blocks == o.n_blocks + 1


def test_repeat_filler_id_list(fixtures_dir, tmp_path):
    """--idList outputs only the chains named, patched as in a full run."""
    all_ids = [c.id for c in read_chains(os.path.join(
        fixtures_dir, "repeatfiller_input.chain"))]
    full, sel = str(tmp_path / "full.chain"), str(tmp_path / "sel.chain")
    assert port_main(["RepeatFiller", *_rf_args(fixtures_dir), "-o", full,
                      "-device=cpu"]) == 0
    assert port_main(["RepeatFiller", *_rf_args(fixtures_dir), "-o", sel,
                      f"--idList={all_ids[0]}", "-device=cpu"]) == 0
    full_chains = {c.id: c.to_text() for c in read_chains(full)}
    sel_chains = read_chains(sel)
    assert {c.id for c in sel_chains} == {all_ids[0]}
    for c in sel_chains:
        assert c.to_text() == full_chains[c.id]


def _write_indel_workload(tmp_path):
    """test_repeat_filler.py:77-143: one 80 bp anchor above the HSP threshold
    and 20 short diverged pieces behind 1-3 bp indels inside a chain gap."""
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = bases[rng.integers(0, 4, 40_000)].copy()
    q = bases[rng.integers(0, 4, 40_000)].copy()

    def plant(tpos, qpos, length, identity):
        frag = t[tpos:tpos + length].copy()
        mut = rng.random(length) > identity
        frag[mut] = bases[rng.integers(0, 4, int(mut.sum()))]
        q[qpos:qpos + length] = frag

    blocks = []
    tp, qp = 1_000, 1_200
    for _ in range(4):
        plant(tp, qp, 500, 0.95)
        blocks.append((tp, tp + 500, qp, qp + 500))
        tp += 520
        qp += 520
    gap_t0, gap_q0 = tp, qp
    ht, hq = gap_t0 + 900, gap_q0 + 900
    plant(ht, hq, 80, 0.97)
    planted = 80
    ht += 80
    hq += 80
    for i in range(20):
        ht += 1 + i % 3
        plant(ht, hq, 15, 0.92)
        planted += 15
        ht += 15
        hq += 15
    tp, qp = gap_t0 + 3_000, gap_q0 + 3_100
    for _ in range(4):
        plant(tp, qp, 500, 0.95)
        blocks.append((tp, tp + 500, qp, qp + 500))
        tp += 520
        qp += 520
    b = np.array(blocks, np.int64)
    chain = Chain(score=500_000, t_name="chrT", t_size=40_000,
                  t_start=int(b[0, 0]), t_end=int(b[-1, 1]),
                  q_name="chrQ", q_size=40_000, q_strand="+",
                  q_start=int(b[0, 2]), q_end=int(b[-1, 3]), id=1, blocks=b)
    t2, q2 = str(tmp_path / "t.2bit"), str(tmp_path / "q.2bit")
    cf = str(tmp_path / "in.chain")
    write_twobit(t2, [("chrT", t.tobytes())])
    write_twobit(q2, [("chrQ", q.tobytes())])
    with open(cf, "w") as f:
        write_chains([chain], f)
    return cf, t2, q2, (gap_t0, gap_t0 + 3_000), planted


def test_repeat_filler_gapped_stage_recovers_indel_homology(tmp_path):
    """The gapped stage recovers the planted indel homology; without it
    (gapped_threshold=None, an engine option the CLI does not take) most of
    it stays invisible."""
    cf, t2, q2, (g0, g1), planted = _write_indel_workload(tmp_path)

    def gap_aligned(**kw):
        out = io.StringIO()
        rf.repeat_filler(cf, t2, q2, out, device="cpu", **kw)
        b = read_chains(io.StringIO(out.getvalue()))[0].blocks
        inside = (b[:, 0] >= g0) & (b[:, 1] <= g1)
        return int((b[inside, 1] - b[inside, 0]).sum())

    perf_reset()
    got = gap_aligned()
    assert PERF["band_problems"] > 0
    assert got >= 0.85 * planted, (got, planted)
    got_ungapped = gap_aligned(gapped_threshold=None)
    assert got_ungapped <= 0.45 * planted, (got_ungapped, planted)
    assert got > 2 * got_ungapped


def test_repeat_filler_gapped_left_extension_coordinates(tmp_path):
    """Left extensions land on the true homology, not its mirror
    (test_repeat_filler.py:177-217)."""
    from genomealignmenttools_tpu_torch.device.genome import Genome
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = bases[rng.integers(0, 4, 4000)].copy()
    q = bases[rng.integers(0, 4, 4000)].copy()
    q[2000:2060] = t[2000:2060]
    q[1975:2000] = t[1972:1997]
    t2, q2 = str(tmp_path / "t.2bit"), str(tmp_path / "q.2bit")
    write_twobit(t2, [("c", t.tobytes())])
    write_twobit(q2, [("c", q.tobytes())])
    tg, qg = Genome(t2), Genome(q2)
    perf_reset()
    blocks = _aligner().align(tg.codes("c"), qg.codes("c"), 1500, 2500,
                              1500, 2500)
    assert PERF["band_problems"] > 0
    found = [b for b in blocks if b[0] < 2000 and b[4] > 0]
    assert found, blocks
    tc, qc = tg.codes("c"), qg.codes("c")
    for ts, te, qs, qe, _sc in found:
        assert float((tc[ts:te] == qc[qs:qe]).mean()) > 0.9, (ts, te, qs, qe)


def test_repeat_filler_batched_band_path_matches_sequential(fixtures_dir,
                                                            monkeypatch):
    """One band batch per chunk of gaps (chunk 1 forces many) and the
    sequential per-gap path (GAT_RF_BATCH=0) give the same bytes."""
    import functools
    orig = rf._run_gap_jobs
    batched = _rf_engine(fixtures_dir)
    monkeypatch.setattr(rf, "_run_gap_jobs", functools.partial(orig, chunk=1))
    chunked = _rf_engine(fixtures_dir)
    monkeypatch.undo()
    monkeypatch.setenv("GAT_RF_BATCH", "0")
    sequential = _rf_engine(fixtures_dir)
    assert batched == sequential
    assert chunked == sequential


def test_repeat_filler_native_hsp_scan_matches_numpy(fixtures_dir,
                                                     monkeypatch):
    native = _rf_engine(fixtures_dir)
    monkeypatch.setenv("GAT_HSP_NATIVE", "0")
    assert native == _rf_engine(fixtures_dir)


# --- the patchChain tests of tests/test_drivers.py --------------------------

def _pc_inputs(fix):
    return [os.path.join(fix, n) for n in (
        "repeatfiller_input.chain", "target.2bit", "query.2bit",
        "target.chrom.sizes", "query.chrom.sizes")]


def test_patch_chain_finds_planted_homolog(fixtures_dir, tmp_path):
    out = str(tmp_path / "out.psl")
    perf_reset()
    assert port_main(["patchChain", *_pc_inputs(fixtures_dir), out,
                      "-unmask", "-device=cpu"]) == 0
    assert PERF["band_problems"] > 0
    psls = read_psls(out)
    assert len(psls) >= 2
    for p in psls:
        assert p.matches + p.rep_matches + p.mis_matches >= 700
        assert p.t_name == "chrB" and p.q_name == "chrQ2"


def test_patch_chain_sharding_is_partition(fixtures_dir, tmp_path):
    outs = []
    for extra in ([], ["-numShards=2", "-shard=0"],
                  ["-numShards=2", "-shard=1"]):
        outs.append(str(tmp_path / f"out{len(outs)}.psl"))
        assert port_main(["patchChain", *_pc_inputs(fixtures_dir), outs[-1],
                          *extra, "-device=cpu"]) == 0
    text = [open(p).read() for p in outs]
    assert sorted((text[1] + text[2]).splitlines()) == \
        sorted(text[0].splitlines())


def test_patch_chain_masked_seeding(tmp_path):
    """Seeding skips soft-masked bases unless -unmask
    (test_drivers.py:191-235)."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    flank = bases[rng.integers(0, 4, 500)].tobytes()
    flank2 = bases[rng.integers(0, 4, 500)].tobytes()
    homolog = bases[rng.integers(0, 4, 400)].tobytes()
    pad = bases[rng.integers(0, 4, 300)].tobytes()
    pad2 = bases[rng.integers(0, 4, 300)].tobytes()
    t_seq = flank + pad + homolog.lower() + pad2 + flank2
    q_seq = flank + homolog.lower() + flank2
    t2, q2 = str(tmp_path / "t.2bit"), str(tmp_path / "q.2bit")
    write_twobit(t2, [("chrT", t_seq)])
    write_twobit(q2, [("chrQ", q_seq)])
    for p, n, ln in ((tmp_path / "t.sizes", "chrT", len(t_seq)),
                     (tmp_path / "q.sizes", "chrQ", len(q_seq))):
        p.write_text(f"{n}\t{ln}\n")
    t_len, q_len = len(t_seq), len(q_seq)
    chain_file = tmp_path / "in.chain"
    chain_file.write_text(
        f"chain 1000 chrT {t_len} + 0 {t_len} chrQ {q_len} + 0 "
        f"{q_len} 1\n500\t{t_len - 1000}\t{q_len - 1000}\n500\n\n")

    def run(unmask):
        out = str(tmp_path / f"out{int(unmask)}.psl")
        assert port_main(["patchChain", str(chain_file), t2, q2,
                          str(tmp_path / "t.sizes"),
                          str(tmp_path / "q.sizes"), out,
                          *(["-unmask"] if unmask else []),
                          "-device=cpu"]) == 0
        return read_psls(out)
    assert len(run(True)) >= 1
    assert len(run(False)) == 0


def test_patch_chain_make_jobs(fixtures_dir, tmp_path):
    """The 5-argument mode writes job scripts that carry -device=cpu
    (cli/main.py:549-550) and run the port's CLI; the union of their outputs
    is the unsharded run."""
    from conftest import hermetic_cpu_env
    job_list = str(tmp_path / "jobList")
    out_dir = str(tmp_path / "out")
    assert port_main(["patchChain", *_pc_inputs(fixtures_dir),
                      f"-jobDir={tmp_path / 'jobs'}", f"-outputDir={out_dir}",
                      f"-jobList={job_list}", "-numJobs=2",
                      "-device=cpu"]) == 0
    scripts = open(job_list).read().splitlines()
    assert len(scripts) == 2
    env = hermetic_cpu_env()
    env["OMP_NUM_THREADS"] = "1"
    for s in scripts:
        assert "-device=cpu" in open(s).read()
        subprocess.run(["sh", s], check=True, env=env, timeout=300)
    full = io.StringIO()
    patch_chain(*_pc_inputs(fixtures_dir), full, device="cpu")
    shard_lines = []
    for i in range(2):
        shard_lines += open(os.path.join(out_dir, f"patch{i}.psl")).read() \
            .splitlines()
    assert sorted(shard_lines) == sorted(full.getvalue().splitlines())
