"""The chainnet.window cell: the plain chainNet reference against the C
tool's goldens, its check and control, the cell's runs on the CPU with
each fault a net can have, and the readers of the chainNet engine's
phases."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from benchmark.lib.manifest import Manifest
from benchmark.reference import chainnet as ref
from benchmark.reference.common import read_chains
from benchmark.reference.scoring import Scorer
from benchmark.workloads import cleaner

from conftest import REPO, run_cpu
from test_harness_runs import add_fault_cell

FIX = os.path.join(REPO, "tests", "fixtures")
GOLD = os.path.join(REPO, "tests", "golden")
CONFIG = json.load(open(os.path.join(
    REPO, "benchmark", "configs", "chainnet-planted-loose.json")))
CELL = "chainnet.window"
MAN = Manifest(REPO)


def read_twobit(path: str) -> dict:
    """{name: codes} of a .2bit file, in .2bit's code order T C A G, with
    4 where an N block lies (masks are case only and do not score)."""
    with open(path, "rb") as f:
        d = f.read()
    n = struct.unpack_from("<IIII", d, 0)[2]
    off, index = 16, []
    for _ in range(n):
        k = d[off]
        index.append((d[off + 1:off + 1 + k].decode(),
                      struct.unpack_from("<I", d, off + 1 + k)[0]))
        off += 5 + k
    out = {}
    for name, o in index:
        size, nb = struct.unpack_from("<II", d, o)
        starts = struct.unpack_from(f"<{nb}I", d, o + 8)
        sizes = struct.unpack_from(f"<{nb}I", d, o + 8 + 4 * nb)
        o += 8 + 8 * nb
        masks = struct.unpack_from("<I", d, o)[0]
        o += 4 + 8 * masks + 4
        packed = np.frombuffer(d, np.uint8, (size + 3) // 4, o)
        codes = np.stack([packed >> 6, packed >> 4, packed >> 2, packed],
                         1).reshape(-1)[:size] & 3
        for s, z in zip(starts, sizes):
            codes[s:s + z] = 4
        out[name] = codes
    return out


def fixture_scorer(t_path: str, q_path: str):
    """Subset scores on the fixtures' genomes, one Scorer a pair of
    sequences.  The genomes hold N, which scores 0 against any base
    (kent's axtScoreSchemeDefault leaves its row 0); Scorer looks up code
    pair t * 4 + q, so the target's codes are doubled and the table spread
    to 40 entries: 8 t + q is one entry a pair, the complement of N (4 ^ 2
    = 6) included, and every pair with an N is 0."""
    t_g, q_g = read_twobit(t_path), read_twobit(q_path)
    gaps = CONFIG["linear_gap_tables"]["loose"]
    acgt = CONFIG["score_matrix_acgt"]
    four = Scorer(t_g[next(iter(t_g))], q_g[next(iter(q_g))], acgt,
                  gaps).lut
    lut = np.zeros(40, np.int64)
    for t in range(4):
        lut[8 * t:8 * t + 4] = four[4 * t:4 * t + 4]
    made: dict = {}

    def score(chains):
        out = np.empty(len(chains))
        groups: dict = {}
        for i, c in enumerate(chains):
            groups.setdefault((c["t_name"], c["q_name"]), []).append(i)
        for (t, q), idx in groups.items():
            if (t, q) not in made:
                made[t, q] = Scorer(t_g[t] * 2, q_g[q], acgt, gaps)
                made[t, q].lut = lut
            out[idx] = made[t, q].scores([chains[i] for i in idx])
        return out
    return score


SYNTH = ("synthetic.scored.sorted.chain", "target.chrom.sizes",
         "query.chrom.sizes", "target.2bit", "query.2bit")
DUP = tuple(os.path.join("dupnet", n) for n in (
    "dupnet.scored.sorted.chain", "target.chrom.sizes", "query.chrom.sizes",
    "target.2bit", "query.2bit"))
# golden file -> (inputs, side, flags): the C tool's runs of
# tests/make_fixtures.py and tests/make_dupnet_fixture.py
GOLDENS = {
    "chainNet.target.net": (SYNTH, 0, {}),
    "chainNet.query.net": (SYNTH, 1, {}),
    "chainNetRescore.target.net": (SYNTH, 0, {"rescore": True}),
    "chainNetRescore.query.net": (SYNTH, 1, {"rescore": True}),
    "dupnet/chainNet.tnet": (DUP, 0, {}),
    "dupnet/chainNet.qnet": (DUP, 1, {}),
    "thresholds/net.minspace400.tnet": (SYNTH, 0, {"min_space": 400}),
    "thresholds/net.minspace400.qnet": (SYNTH, 1, {"min_space": 400}),
    "thresholds/net.minfill600.tnet": (SYNTH, 0, {"min_fill": 600}),
    "thresholds/net.minfill600.qnet": (SYNTH, 1, {"min_fill": 600}),
    "thresholds/net.minscore90k.tnet": (SYNTH, 0, {"min_score": 90000}),
    "thresholds/net.minscore90k.qnet": (SYNTH, 1, {"min_score": 90000}),
}


def fixture_nets(inputs, **flags):
    chain, t_sizes, q_sizes, t2, q2 = (os.path.join(FIX, n) for n in inputs)
    if flags.get("rescore") and not flags.get("approximate"):
        flags["score_subsets"] = fixture_scorer(t2, q2)
    return ref.nets(read_chains(chain), ref.read_sizes(t_sizes),
                    ref.read_sizes(q_sizes), **flags)


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_reference_writes_the_c_golden(golden):
    inputs, side, flags = GOLDENS[golden]
    with open(os.path.join(GOLD, golden)) as f:
        assert fixture_nets(inputs, **flags)[side] == f.read()


def test_control_differs_from_the_rescored_golden():
    """Stock chainNet's share of the chain's score, where -rescore scores
    a partial fill exactly: the same lines, other scores."""
    t, _ = fixture_nets(SYNTH, rescore=True, approximate=True)
    with open(os.path.join(GOLD, "chainNetRescore.target.net")) as f:
        want = f.read().splitlines()
    wrong, gap = ref.compare(t.splitlines(), want)
    assert wrong == 0 and gap > 0


def test_compare_counts_missing_extra_and_moved_lines():
    want = ["net chrA 100", " fill 0 50 chrQ + 0 50 id 1 score 10 ali 40",
            "  gap 10 5 chrQ + 10 5", "  gap 20 5 chrQ + 20 5",
            " fill 60 10 chrQ + 60 10 id 2 score 7 ali 10"]
    assert ref.compare(want, want) == (0, 0.0)
    rescored = list(want)
    rescored[1] = rescored[1].replace("score 10", "score 13")
    assert ref.compare(rescored, want) == (0, 3.0)
    assert ref.compare(want[:2] + want[3:], want) == (1, 0.0)
    assert ref.compare(want + ["  gap 1 1 chrQ + 1 1"], want) == (1, 0.0)
    swapped = want[:2] + [want[3], want[2]] + want[4:]
    assert ref.compare(swapped, want) == (1, 0.0)
    assert ref.compare(ref.alter(want), want) == (0, 1.0)


def test_traffic_flags_are_the_check_s():
    traffic = MAN.traffic(MAN.cell(CELL)["traffic"])
    assert traffic["flags"]["min_space"] == ref.MIN_SPACE
    assert traffic["flags"]["rescore"] is ref.RESCORE
    assert traffic["flags"] == CONFIG["flags"]
    assert MAN.cell(CELL)["config"] == CONFIG["name"]
    assert set(traffic["limits"]) == {"lines_wrong", "score_gap_max"}


def test_reference_and_entry_load_no_jax():
    """The reference loads nothing of the port or of JAX; the entry
    imports the port only when it prepares a call."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import chainnet\n"
            "from benchmark.entries import chain_net_rescore\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'genomealignmenttools_tpu', "
            "'genomealignmenttools_tpu_torch')]\n"
            "print(bad)\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("chainnet"))
    return cleaner.generate(2 ** 33 + 19, {"n_scenarios": 10,
                                           "n_bulk": 40}, d), d


def test_check_of_the_reference_s_own_nets(small):
    w, d = small
    t, q = ref.expected(w, CONFIG)
    good = ref._write(d, "good", (t, q))
    assert dict(ref.check(w, CONFIG, good)) == {"lines_wrong": 0,
                                                 "score_gap_max": 0}
    # each broken chain fills two gaps of its breaking chain: 20 partial
    # target fills, each given its share of the chain's score
    parts = ref.Net(w["chains"], *ref._sizes(w), ref.MIN_SPACE, None, 0)
    assert sum(parts.partial(f) for f in parts.fills(False)) == 20
    ctrl = dict(ref.check(w, CONFIG, ref.control(w, CONFIG, d, None)))
    assert ctrl["lines_wrong"] == 0 and ctrl["score_gap_max"] > 1000
    got = dict(ref.check(w, CONFIG, ref.faults(w, d, good)["altered"]))
    assert got == {"lines_wrong": 0, "score_gap_max": 1}
    # the query net alone moved by one line
    lines = q.splitlines()
    moved = ref._write(d, "moved", (t, "\n".join(
        lines[:2] + lines[3:] + lines[2:3]) + "\n"))
    assert dict(ref.check(w, CONFIG, moved))["lines_wrong"] == 1


# A fault entry for nets, planted under the timed path:
#   control    the check's control (stock chainNet's scores) replaces them
#   unchanged  the nets written without rescoring (stock chainNet's
#              scores, its minScore of 2000)
#   half       the tool runs on the first half of the chains
#   altered    one fill's score + 1
NET_FAULT_ENTRY = '''
import os, shutil
from benchmark.lib.manifest import Manifest
from benchmark.reference.common import read_chains, write_chains

def prepare(workload, config, traffic, device, out_dir):
    man = Manifest(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    kind, of = traffic["fault"], traffic["of"]
    real = man.module("entries", of)
    check = man.module("reference", traffic["check"])
    p = workload["paths"]
    if kind == "half":
        half = dict(workload, paths=dict(p, chain=p["chain"] + ".half"))
        chains = read_chains(p["chain"])
        write_chains(half["paths"]["chain"], chains[:len(chains) // 2])
        return real.prepare(half, config, traffic, device, out_dir)
    if kind == "unchanged":
        traffic = dict(traffic, flags=dict(traffic["flags"], rescore=False))
    call = real.prepare(workload, config, traffic, device, out_dir)

    def broken():
        outs = call()
        if kind == "control":
            for src, dst in zip(check.control(workload, config, out_dir,
                                              None), outs):
                shutil.copy(src, dst)
        elif kind == "altered":
            with open(outs[0]) as f:
                lines = check.alter(f.read().splitlines())
            with open(outs[0], "w") as f:
                f.write("\\n".join(lines) + "\\n")
        return outs
    return broken
'''


def add_net_fault_cell(root: str, fault: str) -> str:
    name = add_fault_cell(root, CELL, fault)
    with open(os.path.join(root, "benchmark", "entries", "fault.py"),
              "w") as f:
        f.write(NET_FAULT_ENTRY)
    return name


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct(small_copy, trace):
    rc, res, err = run_cpu(small_copy, CELL, seconds=6, trace=trace)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"] == {"lines_wrong": {"value": 0, "limit": 0},
                             "score_gap_max": {"value": 0, "limit": 0}}
    man = json.load(open(os.path.join(small_copy, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in man[kind]
            if "workloads" not in m or CELL in m["workloads"]}
    if trace:        # no card here: the trace's metrics find nothing
        want = {m for m in want if "device" not in m}
        assert {"chainnet.parse_s", "chainnet.sweep_s",
                "chainnet.rescore_fills_s", "chainnet.write_s"} <= want
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("fault", ["control", "unchanged", "half",
                                   "altered"])
def test_fault_is_not_correct(small_copy, fault):
    name = add_net_fault_cell(small_copy, fault)
    rc, res, err = run_cpu(small_copy, name)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
    assert res["failed"] == res["attempted"]
    bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert ("lines_wrong" if fault == "half" else "score_gap_max") in bad


class Run:
    def __init__(self, phases):
        self.calls = [0.5, 0.7, 0.6, 0.9]
        self.phases = phases


PHASES = {"chainnet: parse": 0.2, "chainnet: net sweep": 0.4,
          "chainnet: rescore fills": 0.8, "rescore: native combine": 0.01,
          "rescore: chunk blocks": 0.03, "chainnet: write": 0.6,
          "cleaner: net": 0.5}


@pytest.mark.parametrize("name,seconds", [
    ("chainnet.parse_s", 0.2), ("chainnet.sweep_s", 0.4),
    ("chainnet.rescore_fills_s", 0.8), ("chainnet.write_s", 0.6)])
def test_span_reader_is_a_mean_a_call(name, seconds):
    reader = MAN.module("metrics", name)
    assert reader.read(Run(PHASES)) == pytest.approx(seconds / 4)
    # the parent's engine, whose phases had no `chainnet: ` names
    assert reader.read(Run({"parse": 1.0, "net_sweep": 0.1,
                            "rescore_fills": 0.3, "write": 0.2})) is None
    assert reader.read(Run(None)) is None
