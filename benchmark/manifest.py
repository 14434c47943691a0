"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the file its entry names (``benchmark/configs/``);
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a cell's correctness limits: ``benchmark/limits/<workload>.json``;
* a per-layer metric's reader: ``benchmark/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the value or None.

So a later change adds a configuration, a mix, a cell or a metric by adding
files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """The manifest at ``root``, with lookups by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(HERE, "traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return load_json(os.path.join(HERE, "limits", f"{workload}.json"))[
            "limits"]

    def metrics(self) -> Dict[str, dict]:
        return {m["name"]: m for m in self.spec["end_to_end"]
                + self.spec["per_layer"]}

    def readers(self, workload: str) -> Dict[str, Callable]:
        """The read functions of the per-layer metrics that list
        ``workload`` (or list no cells)."""
        out = {}
        for m in self.spec["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            out[m["name"]] = reader(m["name"])
        return out


def reader(name: str) -> Callable:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
