"""BENCHMARK.json against the contract's form, and every file it names."""

import json
import math
import os
import re

import pytest

from benchmark import manifest

from .conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[key]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names(name):
    assert NAME.match(name), name


def test_top_level_keys_and_limits():
    assert sorted(SPEC) == sorted(["command", "paths", "run_seconds",
                                   "configs", "workloads", "end_to_end",
                                   "per_layer"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert len(os.path.join(ROOT, "BENCHMARK.json")) and \
        os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word.split("/")


def test_units_sources_and_bounds():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert LINE.match(m["layer"])


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        e2e = [m for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", cells)]
        assert len(e2e) >= 2 and any(m["name"] == "setup_s" for m in e2e)
        moved = {m["name"] for m in e2e}
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", cells)]
        assert layer and all(m["moves"] in moved for m in layer)


def test_files_by_name():
    bench = manifest.Benchmark(ROOT)
    for c in SPEC["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(SPEC["paths"][0] + "/")
    for w in SPEC["workloads"]:
        bench.traffic(w["traffic"])
        limits = bench.limits(w["name"])
        assert limits and all(math.isfinite(v) and v > 0
                              for v in limits.values())
        for name, read in bench.readers(w["name"]).items():
            assert callable(read), name
