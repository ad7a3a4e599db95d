"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration file
names its generator (`workloads/<generator>.py`), the traffic file its entry
(`entries/<entry>.py`) and its check (`reference/<check>.py`); a metric is
read by `metrics/<metric name>.py`.  Adding any of them is adding files."""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Manifest:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.bench_dir = os.path.join(root, "benchmark")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = os.path.join(self.bench_dir, "traffic", name + ".json")
        with open(path) as f:
            return json.load(f)

    def metrics(self, cell: str, per_layer: bool) -> list[dict]:
        """The metrics a cell reports: all of the kind that list it, or that
        list no cells."""
        key = "per_layer" if per_layer else "end_to_end"
        return [m for m in self.data[key]
                if "workloads" not in m or cell in m["workloads"]]

    def module(self, kind: str, name: str):
        """benchmark/<kind>/<name>.py, imported as a module of the package
        when its name allows, else from its file (metric names hold dots)."""
        if not NAME.match(name):
            raise ValueError(f"bad {kind} name {name!r}")
        path = os.path.join(self.bench_dir, kind, name + ".py")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        spec = importlib.util.spec_from_file_location(
            f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}",
            path, submodule_search_locations=None)
        mod = importlib.util.module_from_spec(spec)
        mod.__package__ = f"benchmark.{kind}"
        spec.loader.exec_module(mod)
        return mod

