"""BENCHMARK.json keeps to the contract's form, names and characters, and
names only files that exist."""

import json
import os
import re

import pytest

from benchmark.lib.manifest import NAME, Manifest

from conftest import REPO

DATA = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ENTRY_KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer",
                            "moves"}}
TEXT = re.compile(r"^[^\n\t]{1,200}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")



def check_names(data: dict) -> list[str]:
    """The names and units of a manifest that break the contract's
    character rules."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in data.get(key, []):
            for field in ("name", "config", "traffic"):
                if field in e and not NAME.match(e[field]):
                    bad.append(f"{key}.{field}: {e[field]!r}")
            for r in e.get("reduced", []):
                if not NAME.match(r):
                    bad.append(f"{key}.reduced: {r!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(f"{key}.unit: {e['unit']!r}")
    return bad


def test_top_level():
    assert set(DATA) == KEYS
    assert DATA["paths"] == ["benchmark"]
    assert DATA["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(DATA["run_seconds"], int)
    assert 1 <= DATA["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entry_keys(kind):
    for e in DATA[kind]:
        extra = set(e) - ENTRY_KEYS[kind]
        assert set(e) >= ENTRY_KEYS[kind], e["name"]
        assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer")
                         else set()), e["name"]


def test_names_and_units():
    assert check_names(DATA) == []
    names = [e["name"] for k in ENTRY_KEYS for e in DATA[k]]
    for k in ENTRY_KEYS:
        ns = [e["name"] for e in DATA[k]]
        assert len(ns) == len(set(ns)), k
    metrics = [e["name"] for k in ("end_to_end", "per_layer")
               for e in DATA[k]]
    assert len(metrics) == len(set(metrics))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in DATA[k])
    for e in DATA["configs"] + DATA["workloads"]:
        assert TEXT.match(e["why"]), e["name"]
    for c in DATA["configs"]:
        assert TEXT.match(c["source"])
    for m in DATA["per_layer"]:
        assert TEXT.match(m["layer"])
    assert not NAME.match("a b") and not NAME.match("a/b")
    assert not UNIT.match("tokens per second") and UNIT.match("tokens/s")


def test_cells_and_metrics():
    man = Manifest(REPO)
    cells = {w["name"] for w in DATA["workloads"]}
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DATA["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    for m in DATA["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:     # each cell reports what it moves
            assert m in man.metrics(w, per_layer=True)
            assert e2e[m["moves"]] in man.metrics(w, per_layer=False)
    for w in DATA["workloads"]:
        assert w["chips"] in (1, 4)
        assert man.traffic(w["traffic"])["entry"]
        reported = [m["name"] for m in man.metrics(w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert man.metrics(w["name"], True)
        cfg = man.config(w["config"])
        for f in ("generator", "params", "flags"):
            assert f in cfg
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_config_files_hold_no_undeclared_cut():
    for c in DATA["configs"]:
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
