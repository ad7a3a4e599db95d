"""The variant table (tests/variant_cases.py) on the CPU.

chip_smoke.py's [variants] phase runs every row of the table on the card.
Here, every row that no older test of the port holds (its `twin` is
test_variant_row_on_cpu) runs through the same runner with -device=cpu and
must be what the row holds it to, with the same launch expectation, counted
here as calls of the kernels' wrappers (variant_cases.Launches).  Rows of a
setting other than "main" run in one fresh interpreter per setting, as on
the card, which must load neither jax nor the JAX package.

The meta-tests read the port's source: every GAT_* name it reads from the
environment is a variant of the table, a name of golden_cases' modes or
cases, or a knob that picks no card path (NO_CARD_PATH, with its reason);
every row names a CPU twin that exists.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import golden_cases as gc
import variant_cases as vc
from conftest import hermetic_cpu_env

PORT = os.path.join(os.path.dirname(gc.HERE), "genomealignmenttools_tpu_torch")
TABLE = vc.rows("")
NEW = [rid for rid, row in TABLE.items() if row.twin == vc.NEW_TWIN]

# the names the port reads that pick no path of the card, and why
NO_CARD_PATH = {
    "GAT_BAND": "only `host` (or auto): the host band batch, the base of "
                "the 24-gap rows and the oracle of chip_smoke's gap phases; "
                "auto is the card's K3 path",
    "GAT_BAND_NATIVE": "read by the host band batch alone (GAT_BAND=host): "
                       "its native C++ or numpy band_ext",
    "GAT_NATIVE_SO": "loads another build of the host library (the "
                     "-fsanitize=thread build of tools/tsan_check.sh)",
    "GAT_PROFILE": "the directory of -profile's trace; the [profile] phase "
                   "runs the profiler on the card",
}


def names_read_from_environment() -> set:
    """Every GAT_* name the port's python reads through os.environ, and its
    native code through getenv."""
    pattern = re.compile(r"(?:environ(?:\.get)?\(\s*|environ\[\s*|getenv\(\s*)"
                         r"\"(GAT_[A-Z0-9_]+)\"")
    names = set()
    for root, _, files in os.walk(PORT):
        if "build" in root:
            continue
        for name in files:
            if name.endswith((".py", ".cpp", ".h", ".cu")):
                with open(os.path.join(root, name)) as fh:
                    names |= set(pattern.findall(fh.read()))
    return names


def test_every_environment_name_is_a_variant_or_picks_no_card_path():
    names = names_read_from_environment()
    assert {"GAT_THREADS", "GAT_NATIVE", "GAT_PAIR_CHUNK", "GAT_COMBINE",
            "GAT_RF_BATCH", "GAT_HSP_NATIVE", "GAT_RESCORE"} <= names
    covered = {k for row in TABLE.values() if row.held[0] != "base"
               for k in row.env}
    covered |= {k for env in vc.SETTINGS.values() for k in env}
    covered |= {k for env in gc.MODES.values() for k in env}
    covered |= {k for _, env, _ in gc.scoring_cases("").values() for k in env}
    assert not covered & set(NO_CARD_PATH)
    assert names - covered == set(NO_CARD_PATH)


def test_every_row_names_a_cpu_twin_that_exists():
    for row in TABLE.values():
        path, name = row.twin.split("::")
        with open(os.path.join(gc.HERE, path)) as fh:
            assert f"def {name}(" in fh.read(), row.id


def test_the_table_holds_every_variant():
    """The widths in every format, both thread counts, 2 and 3 shards in
    every mode, GAT_NATIVE=0, auto/host and the overflow fallback, the
    per-gap band path and the python HSP scan; K2's keys are the port's."""
    from genomealignmenttools_tpu_torch.ops.pair_combine import LAUNCH_KEY
    for mode, key in vc.K2_OF.items():
        assert LAUNCH_KEY[gc.MODES[mode]["GAT_PAIR_TILES"] or "score8"] == key
    ids = set(TABLE)
    for mode in vc.PAIR_MODES:
        for chunk in ("2", "6", "130", "258"):
            assert {f"width{chunk}-chainNet-{mode}",
                    f"width{chunk}-chainCleaner-{mode}"} <= ids
        assert {f"combine_auto-scorer-{mode}",
                f"combine_host-scorer-{mode}"} <= ids
    for mode in gc.MODES:
        assert {f"shards2-chainCleaner-{mode}", f"shards3-chainCleaner-{mode}",
                f"seam-clean_chains-{mode}", f"seam-chain_net-{mode}"} <= ids
    for n in (1, 8):
        assert {r for r in ids if r.startswith(f"threads{n}-")} == {
            f"threads{n}-{t}-lite-{m}" for t in ("chainCleaner", "chainNet")
            for m in ("window", "pair")} | {f"threads{n}-RepeatFiller-rf24"}
    assert {row.id for row in TABLE.values() if row.setting == "native0"} \
        == {f"native0-{t}-{m}" for t in ("scoreChain", "chainNet",
                                         "chainCleaner")
            for m in ("window", "pair")}
    assert "combine_overflow-scorer-pair" in ids
    assert TABLE["band-RepeatFiller-per_gap"].env == {"GAT_RF_BATCH": "0"}
    assert TABLE["band-RepeatFiller-hsp_python"].env == {
        "GAT_HSP_NATIVE": "0"}
    for row in TABLE.values():
        assert set(row.launches) <= set(vc.KERNELS), row.id
        if row.held[0] == "row":
            assert len(TABLE[row.held[1]].outputs) == len(row.outputs)
        if row.group == "widths":
            chunk = int(row.env["GAT_PAIR_CHUNK"])
            assert row.checked == (vc.K2_OF[row.mode], chunk // 2 if
                                   row.mode == "pair-score4" else chunk,
                                   None), row.id
    # the 24-gap rows are held to the host band batch, which launches
    # nothing; every per-gap row holds its K3 launches to the plain version
    base = TABLE["host-RepeatFiller-rf24"]
    assert base.env == {"GAT_BAND": "host"} and base.launches == {}
    assert {r.id for r in TABLE.values() if r.held == ("row", base.id)} == {
        "threads1-RepeatFiller-rf24", "threads8-RepeatFiller-rf24",
        "band-RepeatFiller-per_gap-rf24"}
    assert {r.id for r in TABLE.values() if r.checked and
            r.checked[0] == vc.K3} == {"band-RepeatFiller-per_gap",
                                       "band-RepeatFiller-per_gap-rf24"}


def test_random_chains_are_the_older_test_s():
    """variant_cases' copy of test_torch_rescore._random_chains gives the
    same chains."""
    from test_torch_rescore import _random_chains
    ours, theirs = vc.random_chains(), _random_chains()
    assert len(ours) == len(theirs) == 40
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.blocks, b.blocks)
        assert (a.t_name, a.q_name, a.q_strand, a.t_size, a.q_size, a.id) == \
            (b.t_name, b.q_name, b.q_strand, b.t_size, b.q_size, b.id)


@pytest.fixture(scope="module")
def workloads(tmp_path_factory):
    d = tmp_path_factory.mktemp("variant_work")
    lite_dir, rf_dir = str(d / "lite"), str(d / "rf")
    vc.workloads(lite_dir, rf_dir)
    return lite_dir, rf_dir


@pytest.fixture(scope="module")
def children(workloads, tmp_path_factory):
    """One fresh interpreter per setting other than main, side by side, each
    running its rows of NEW on the CPU: {setting: run_child's payload}."""
    out = str(tmp_path_factory.mktemp("variant_children"))
    procs = {}
    for setting in vc.SETTINGS:
        ids = [r for r in NEW if TABLE[r].setting == setting]
        if setting == "main" or not ids:
            continue
        code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; "
                "import variant_cases as vc; "
                "print(json.dumps(vc.run_child(*sys.argv[3:8], "
                "sys.argv[8].split(','))))")
        procs[setting] = subprocess.Popen(
            [sys.executable, "-c", code, gc.HERE, os.path.dirname(gc.HERE),
             setting, *workloads, out, "cpu", ",".join(ids)],
            env={**hermetic_cpu_env(), **vc.SETTINGS[setting],
                 "OMP_NUM_THREADS": "1"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    payloads = {}
    for setting, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        payloads[setting] = json.loads(stdout.strip().splitlines()[-1])
    return payloads


@pytest.mark.parametrize("rid", NEW)
def test_variant_row_on_cpu(rid, workloads, children, tmp_path):
    """The row through the port on the CPU: its outputs are what it is held
    to and its wrappers are called as its launches on the card must be."""
    import torch
    row = TABLE[rid]
    if row.setting != "main":
        payload = children[row.setting]
        assert payload["foreign"] == []
        result = payload["results"][rid]
        assert vc.problem(row, result, payload["results"]) is None
        return
    lite, rf = vc.workloads(*workloads)
    table = vc.rows(str(tmp_path), lite, rf)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with vc.Launches("cpu") as launches:
            results = {rid: vc.run_row(table[rid], str(tmp_path), "cpu",
                                       launches)}
    finally:
        torch.set_num_threads(threads)
    assert vc.problem(table[rid], results[rid], results) is None
