"""The patchchain.gaps cell: its generator (soft-masked 2bit files the port
reads back), the psl check and its control, the cell's runs on the CPU with
each fault a psl can have, and the readers of patchChain's phases."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.entries import patch_chain as entry
from benchmark.lib.manifest import Manifest
from benchmark.reference import patchchain as ref
from benchmark.workloads import patchchain as gen

from conftest import REPO, run_cpu
from test_harness_runs import add_fault_cell

CELL = "patchchain.gaps"
MAN = Manifest(REPO)
CONFIG = MAN.config(MAN.cell(CELL)["config"])
CONFIG_FILE = next(c["file"] for c in MAN.data["configs"]
                   if c["name"] == CONFIG["name"])
SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("patchchain"))
    return gen.generate(SEED, {"n_gaps": 24}, os.path.join(d, "in")), d


def _digests(paths: dict) -> dict:
    return {k: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for k, p in paths.items()}


def test_generator_is_deterministic_in_the_seed(tmp_path):
    a = gen.generate(SEED, {"n_gaps": 12}, str(tmp_path / "a"))
    b = gen.generate(SEED, {"n_gaps": 12}, str(tmp_path / "b"))
    c = gen.generate(SEED + 1, {"n_gaps": 12}, str(tmp_path / "c"))
    assert _digests(a["paths"]) == _digests(b["paths"])
    assert _digests(a["paths"])["t2bit"] != _digests(c["paths"])["t2bit"]
    assert a["units"] == c["units"] == {"gaps": 12}
    assert len(a["chains"][0]["blocks"]) == len(c["chains"][0]["blocks"])


def test_generator_plants_what_it_says(small):
    w, _ = small
    for k, (t_lo, t_hi, q_lo, q_hi) in enumerate(w["gaps"]):
        assert 1000 <= t_hi - t_lo <= 4000 and 1000 <= q_hi - q_lo <= 4000
        (t0, q0, n0), (t1, q1, n1) = w["pieces"][k]
        assert t1 - (t0 + n0) in (1, 2, 3) and q1 == q0 + n0
        for t, q, n in w["pieces"][k]:
            assert t_lo <= t and t + n <= t_hi and q_lo <= q and q + n <= q_hi
            assert not w["t_mask"][t:t + n].any()
            assert not w["q_mask"][q:q + n].any()
            same = (w["t_codes"][t:t + n] == w["q_codes"][q:q + n]).mean()
            assert 0.55 < same < 0.9
    big = [k for k, (a, b, c, d) in enumerate(w["gaps"])
           if b - a >= 2000 and d - c >= 2000]
    assert list(w["masked"][:, 0]) == big[::4]
    for k, t, q, n in w["masked"]:
        t_lo, t_hi, q_lo, q_hi = w["gaps"][k]
        assert t_lo <= t and t + n <= t_hi and q_lo <= q and q + n <= q_hi
        g = gen.GUARD
        assert w["t_mask"][max(t_lo, t - g):min(t_hi, t + n + g)].all()
        assert w["q_mask"][max(q_lo, q - g):min(q_hi, q + n + g)].all()
        for t1, q1, n1 in w["pieces"][k]:
            assert t - (t1 + n1) >= gen.SEP and q - (q1 + n1) >= gen.SEP
    inside = np.concatenate([w["t_mask"][a:b] for a, b, _, _ in w["gaps"]])
    assert 0.35 < inside.mean() < 0.7


def test_port_reads_the_mask_blocks_back(small):
    """The port's 2bit reader and Genome(..., with_mask=True) see the
    generator's masks and codes."""
    from genomealignmenttools_tpu_torch.device.genome import Genome
    w, _ = small
    for side, name in (("t", "chrT"), ("q", "chrQ")):
        g = Genome(w["paths"][f"{side}2bit"], with_mask=True)
        assert np.array_equal(g.seq(name).mask, w[f"{side}_mask"])
        assert np.array_equal(g.codes(name), w[f"{side}_codes"])
        chars = ref.read_twobit_chars(w["paths"][f"{side}2bit"])[name]
        assert np.array_equal((chars & 0x20) != 0, w[f"{side}_mask"])


def test_score_file_is_hoxd55(tmp_path):
    """The configuration's matrix is tests/fixtures/HoxD55.q's, and the
    entry's .q file carries it with lastz's O and E."""
    def matrix(path):
        rows = [ln.split() for ln in open(path) if ln.strip()]
        assert rows[0] == ["A", "C", "G", "T"]
        return [[int(x) for x in r] for r in rows[1:5]], rows[5:]
    fixture, rest = matrix(os.path.join(REPO, "tests", "fixtures",
                                        "HoxD55.q"))
    assert fixture == CONFIG["score_matrix_acgt"] and rest == []
    path = str(tmp_path / "scores.q")
    entry.write_score_file(path, CONFIG)
    written, rest = matrix(path)
    assert written == fixture
    assert rest == [["O", "=", "400,", "E", "=", "30"]]
    assert CONFIG["lastz"] == {"K": 1500, "L": 2500, "W": 5, "O": 400,
                               "E": 30}


def test_check_of_the_control_and_each_fault(small):
    w, d = small
    ctrl = dict(ref.check(w, CONFIG, ref.control(w, CONFIG, d, None)))
    assert ctrl == {"psl_malformed": 0, "outside_gap": 0, "counts_wrong": 0,
                    "below_gapped_threshold": 0,
                    "masked_homologs_hit": 150 * len(w["masked"]),
                    "homolog_missed_pct": 0.0, "pairs_off_homolog": 0}
    assert len(w["masked"]) > 0
    planted = ref.faults(w, d, ref.control(w, CONFIG, d, None))
    half = dict(ref.check(w, CONFIG, planted["half"]))
    assert 40 < half["homolog_missed_pct"] < 60
    altered = dict(ref.check(w, CONFIG, planted["altered"]))
    assert altered["counts_wrong"] == 1
    shifted = dict(ref.check(w, CONFIG, planted["shifted"]))
    assert shifted["counts_wrong"] == 2 * len(w["pieces"]) \
        + len(w["masked"])
    assert shifted["homolog_missed_pct"] > 90
    assert shifted["pairs_off_homolog"] > 150 * len(w["pieces"])


def test_check_counts_malformed_and_outside_records(small):
    w, d = small
    lines = open(ref.control(w, CONFIG, d, None)[0]).read().splitlines()
    f = lines[0].split("\t")
    f[0] = str(int(f[0]) + 1)                  # the counts' sum is off
    g = lines[1].split("\t")                   # the window of no gap
    t0 = int(w["chains"][0]["blocks"][0, 0])
    g[15], g[16], g[20] = str(t0), str(t0 + 150), f"{t0},"
    g[0:4] = [str(x) for x in ref._recount(
        ref.Record(g), ref.read_twobit_chars(w["paths"]["t2bit"])["chrT"],
        ref.read_twobit_chars(w["paths"]["q2bit"])["chrQ"])]
    path = os.path.join(d, "broken.psl")
    with open(path, "w") as out:
        out.write("\n".join(["\t".join(f), "\t".join(g)] + lines[2:]
                            + ["not a record"]) + "\n")
    got = dict(ref.check(w, CONFIG, [path]))
    assert got["psl_malformed"] == 2 and got["outside_gap"] == 1
    assert got["pairs_off_homolog"] == 150


def test_chain_scores_link_records_of_one_alignment():
    class R:
        def __init__(self, t0, t1, q0, q1):
            self.t_start, self.t_end, self.q_start, self.q_end = \
                t0, t1, q0, q1
    recs = [R(0, 100, 0, 100), R(102, 200, 100, 198), R(900, 950, 500, 550)]
    got = ref._chain_scores(recs, [3000, 2000, 600], 400, 30)
    assert got == [3000 + 2000 - 430] * 2 + [600]


def test_only_seedless_alignments_count_as_masked_hits():
    """A record in lowercase joins the alignment of an unmasked record
    that scores K (it was reached by extension, not seeded); a lowercase
    record linked to none is seeded from nowhere."""
    rng = np.random.default_rng(3)
    t_chars = np.frombuffer(b"TCAG", np.uint8)[rng.integers(0, 4, 900)]
    q_chars = t_chars.copy()
    t_chars[150:250] |= 0x20
    t_chars[600:700] |= 0x20
    lut = ref.score_lut(CONFIG["score_matrix_acgt"])
    recs = [ref.Record(ref._psl_line(t_chars, q_chars, "chrT", "chrQ",
                                     t0, t0, 100).split("\t"))
            for t0 in (0, 150, 600)]
    lz = CONFIG["lastz"]
    assert ref._seedless(recs, t_chars, q_chars, lut, lz["K"],
                         lz["W"]) == [False, False, True]
    # an unmasked record under K seeds nothing
    assert ref._seedless(recs[:2], t_chars, q_chars, lut, 100 * 101,
                         lz["W"]) == [True, True]


def test_reference_and_entry_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import patchchain\n"
            "from benchmark.entries import patch_chain\n"
            "from benchmark.workloads import patchchain as g\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'genomealignmenttools_tpu', "
            "'genomealignmenttools_tpu_torch')]\n"
            "print(bad)\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


# A fault entry for the psl, planted under the timed path:
#   control  the check's control (every planted piece aligned, the masked
#            ones too) replaces the output
#   unmask   the port's own run with -unmask: seeds through the soft mask
#   half     the records of the second half of the gaps left out
#   altered  the longest record moved one base along the target
PSL_FAULT_ENTRY = '''
import os, shutil
from benchmark.lib.manifest import Manifest

def prepare(workload, config, traffic, device, out_dir):
    man = Manifest(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    kind, of = traffic["fault"], traffic["of"]
    real = man.module("entries", of)
    check = man.module("reference", traffic["check"])
    if kind == "unmask":
        config = dict(config, flags=dict(config["flags"], unmask=True))
    call = real.prepare(workload, config, traffic, device, out_dir)

    def broken():
        outs = call()
        if kind == "control":
            src = check.control(workload, config, out_dir, None)
        elif kind in ("half", "altered"):
            src = check.faults(workload, out_dir, outs)[kind]
        else:
            return outs
        shutil.copy(src[0], outs[0])
        return outs
    return broken
'''


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct(small_copy, trace):
    rc, res, err = run_cpu(small_copy, CELL, seconds=6, trace=trace)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert set(res["checks"]) == set(MAN.traffic(
        MAN.cell(CELL)["traffic"])["limits"])
    man = json.load(open(os.path.join(small_copy, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in man[kind]
            if "workloads" not in m or CELL in m["workloads"]}
    if trace:        # no card here: the trace's metrics find nothing
        want = {m for m in want if not ("roofline" in m or "device" in m
                                        or m.startswith("k3."))}
        assert {"pc.seed_s", "pc.hsp_scan_s", "pc.gapped_host_s",
                "pc.psl_s", "pc.io_s", "pc.align_host_s",
                "band.host_s"} <= want
    else:
        assert want == {"gaps_per_s", "setup_s"}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("fault,number", [
    ("control", "masked_homologs_hit"), ("unmask", "masked_homologs_hit"),
    ("half", "homolog_missed_pct"), ("altered", "counts_wrong")])
def test_fault_is_not_correct(small_copy, fault, number):
    if number == "masked_homologs_hit":     # the seed plants a masked piece
        cfg = json.load(open(os.path.join(small_copy, CONFIG_FILE)))
        w = gen.generate(2 ** 33 + 7, cfg["params"],
                         os.path.join(small_copy, "plan"))
        assert len(w["masked"]) > 0
    name = add_fault_cell(small_copy, CELL, fault)
    with open(os.path.join(small_copy, "benchmark", "entries", "fault.py"),
              "w") as f:
        f.write(PSL_FAULT_ENTRY)
    rc, res, err = run_cpu(small_copy, name)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
    assert res["failed"] == res["attempted"]
    bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert number in bad


class Run:
    def __init__(self, phases):
        self.calls = [0.5, 0.7, 0.6, 0.9]
        self.phases = phases


PHASES = {"pc: read + harvest": 0.1, "pc: seed": 0.2, "pc: hsp scan": 0.3,
          "pc: band problems": 0.04, "band: DP + fetch": 0.5,
          "pc: gapped finish": 0.36, "pc: axt + psl": 0.8,
          "patchchain": 2.4, "rf: seed": 9.0, "rf: hsp scan": 9.0}


@pytest.mark.parametrize("name,seconds", [
    ("pc.seed_s", 0.2), ("pc.hsp_scan_s", 0.3), ("pc.gapped_host_s", 0.4),
    ("pc.psl_s", 0.8), ("pc.io_s", 0.9), ("pc.align_host_s", 2.2)])
def test_span_reader_is_a_mean_a_call(name, seconds):
    reader = MAN.module("metrics", name)
    assert reader.read(Run(PHASES)) == pytest.approx(seconds / 4)
    # the parent's engine, whose patchChain had no phases: no number, and
    # no error
    assert reader.read(Run({"band: orient": 0.1,
                            "band: moves to symbols": 0.2})) is None
    assert reader.read(Run(None)) is None
