"""The gap-filling slice of the port on the CPU, byte for byte.

The port's GapAligner against the reference GapAligner on the planted cases;
the port's repeat_filler and patch_chain against the RepeatFiller golden
and the reference engines; the port CLI's RepeatFiller and patchChain with
-device=cpu against the reference CLI.  Every comparison is exact, and each
run must go through the port's band batch (PERF["band_problems"] moves).
"""

import io
import json
import os

import pytest
import torch

from genomealignmenttools_tpu.cli.main import main as jax_main
from genomealignmenttools_tpu.engines.drivers import \
    patch_chain as ref_patch_chain
from genomealignmenttools_tpu.engines.repeat_filler import \
    repeat_filler as ref_repeat_filler
from genomealignmenttools_tpu.formats.scorematrix import score_scheme_default
from genomealignmenttools_tpu.ops.seed_extend import GapAligner
from genomealignmenttools_tpu_torch.cli.main import main as port_main
from genomealignmenttools_tpu_torch.device import PERF, perf_reset
from genomealignmenttools_tpu_torch.engines.drivers import patch_chain
from genomealignmenttools_tpu_torch.engines.repeat_filler import \
    repeat_filler
from genomealignmenttools_tpu_torch.ops.seed_extend import \
    GapAligner as PortGapAligner
from make_planted import build_case

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "golden", "planted_cases.json")) as _f:
    PLANTED = json.load(_f)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain band DP is thousands of small torch ops; under the
    parallel test runner, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _rf_inputs(fix):
    return (os.path.join(fix, "repeatfiller_input.chain"),
            os.path.join(fix, "target.2bit"), os.path.join(fix, "query.2bit"))


def _pc_inputs(fix):
    return _rf_inputs(fix) + (os.path.join(fix, "target.chrom.sizes"),
                              os.path.join(fix, "query.chrom.sizes"))


@pytest.mark.parametrize("case", PLANTED, ids=lambda c: c["spec"]["name"])
def test_torch_gap_aligner_matches_reference_on_planted(case):
    t, q, _ = build_case(case["spec"])
    sch = score_scheme_default()
    kw = dict(seed_len=10, hsp_threshold=1500, gapped_threshold=2000,
              gap_open=sch.gap_open, gap_extend=sch.gap_extend,
              char_matrix=sch.char_matrix())
    want = GapAligner(sch.lut, **kw).align(t, q, 0, t.shape[0], 0,
                                           q.shape[0])
    perf_reset()
    got = PortGapAligner(sch.lut, device="cpu", **kw).align(
        t, q, 0, t.shape[0], 0, q.shape[0])
    assert got == want
    assert (PERF["band_problems"] > 0) == bool(want)


def _repeat_filler(fn, fix, **kw):
    out = io.StringIO()
    fn(*_rf_inputs(fix), out, **kw)
    return out.getvalue()


def test_repeat_filler_quirks_matches_golden(fixtures_dir, golden_dir):
    perf_reset()
    got = _repeat_filler(repeat_filler, fixtures_dir, ref_quirks=True,
                         device="cpu")
    assert PERF["band_problems"] > 0
    with open(os.path.join(golden_dir,
                           "repeatfiller_reference_output.chain")) as f:
        assert got == f.read()


@pytest.mark.parametrize("mode", ["clean", "chain_ids", "shard0", "shard1"])
def test_repeat_filler_matches_reference(fixtures_dir, mode):
    kw = {"clean": {}, "chain_ids": {"chain_ids": {14}},
          "shard0": {"num_shards": 2, "shard": 0},
          "shard1": {"num_shards": 2, "shard": 1}}[mode]
    perf_reset()
    got = _repeat_filler(repeat_filler, fixtures_dir, device="cpu", **kw)
    assert got == _repeat_filler(ref_repeat_filler, fixtures_dir, **kw)
    assert got.count("chain ") >= 1


@pytest.mark.parametrize("mode", ["unmask", "masked", "shard0", "shard1"])
def test_patch_chain_matches_reference(fixtures_dir, mode):
    kw = {"unmask": {"unmask": True}, "masked": {"unmask": False},
          "shard0": {"unmask": True, "num_shards": 2, "shard_index": 0},
          "shard1": {"unmask": True, "num_shards": 2,
                     "shard_index": 1}}[mode]
    got, want = io.StringIO(), io.StringIO()
    perf_reset()
    patch_chain(*_pc_inputs(fixtures_dir), got, device="cpu", **kw)
    ref_patch_chain(*_pc_inputs(fixtures_dir), want, **kw)
    assert got.getvalue() == want.getvalue()
    # the fixture's second shard holds only gaps without an HSP
    assert (PERF["band_problems"] > 0) == (mode != "shard1")
    assert bool(got.getvalue()) == (mode != "shard1")


@pytest.mark.parametrize("tool", ["RepeatFillerQuirks", "RepeatFiller",
                                  "patchChain", "patchChainUnmask"])
def test_port_cli_matches_reference_cli(fixtures_dir, golden_dir, tmp_path,
                                        tool):
    chain, t2, q2, ts, qs = _pc_inputs(fixtures_dir)
    rf = ["RepeatFiller", "-c", chain, "-T2", t2, "-Q2", q2]
    pc = ["patchChain", chain, t2, q2, ts, qs]
    argv, extra = {
        "RepeatFillerQuirks": (rf + ["-o"], ["--refQuirks"]),
        "RepeatFiller": (rf + ["-o"], []),
        "patchChain": (pc, []),
        "patchChainUnmask": (pc, ["-unmask"])}[tool]
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    perf_reset()
    assert port_main(argv + [port_out] + extra + ["-device=cpu"]) == 0
    assert PERF["band_problems"] > 0
    assert jax_main(argv + [ref_out] + extra) == 0
    assert _read(port_out) == _read(ref_out)
    if tool == "RepeatFillerQuirks":
        assert _read(port_out) == _read(os.path.join(
            golden_dir, "repeatfiller_reference_output.chain"))


def test_patch_chain_job_scripts_are_forwarded(fixtures_dir, tmp_path):
    """The 5-argument mode writes job scripts; nothing is forwarded any
    more: the port writes them itself, and they run the port's CLI on the
    device the caller named."""
    jobs = tmp_path / "jobs"
    perf_reset()
    assert port_main(["patchChain", *_pc_inputs(fixtures_dir),
                      f"-jobDir={jobs}", f"-outputDir={tmp_path / 'out'}",
                      f"-jobList={tmp_path / 'jobList'}", "-numJobs=2",
                      "-device=cpu"]) == 0
    assert PERF["band_problems"] == 0
    scripts = (tmp_path / "jobList").read_text().split()
    assert len(scripts) == 2
    for path in scripts:
        with open(path) as f:
            text = f.read()
        assert "genomealignmenttools_tpu_torch.cli.main patchChain" in text
        assert "genomealignmenttools_tpu.cli.main" not in text
        assert "-device=cpu" in text and "-numShards=2" in text


def test_gap_fill_refusals(fixtures_dir, tmp_path, monkeypatch):
    chain, t2, q2, ts, qs = _pc_inputs(fixtures_dir)
    assert port_main(["patchChain", chain, t2, "-device=cpu"]) == 255
    monkeypatch.setenv("GAT_BAND", "pallas")
    with pytest.raises(ValueError, match="GAT_BAND"):
        port_main(["RepeatFiller", "-c", chain, "-T2", t2, "-Q2", q2,
                   "-o", str(tmp_path / "o"), "-device=cpu"])
    with pytest.raises(ValueError, match="GAT_BAND"):
        port_main(["patchChain", chain, t2, q2, ts, qs,
                   str(tmp_path / "o.psl"), "-device=cpu"])


@pytest.mark.parametrize("tool", ["RepeatFiller", "patchChain"])
def test_host_band_batch_runs_only_when_named(fixtures_dir, tmp_path,
                                              monkeypatch, tool):
    """GAT_BAND=host runs the port's copy of the host band batch: the
    reference CLI's bytes, no problem through the torch band wrapper, and
    no device resolved (the default -device would raise here)."""
    chain, t2, q2, ts, qs = _pc_inputs(fixtures_dir)
    argv = {"RepeatFiller": ["RepeatFiller", "-c", chain, "-T2", t2, "-Q2",
                             q2, "-o"],
            "patchChain": ["patchChain", chain, t2, q2, ts, qs]}[tool]
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    monkeypatch.setenv("GAT_BAND", "host")
    perf_reset()
    assert port_main(argv + [port_out]) == 0
    assert PERF["band_problems"] == 0
    assert jax_main(argv + [ref_out]) == 0
    assert _read(port_out) == _read(ref_out) and _read(port_out)
