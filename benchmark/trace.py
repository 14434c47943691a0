"""The reduction of a ``torch.profiler`` trace of the window to what the
per-layer readers and the breakdown need.

A frozen copy of the arithmetic of ``scripts/read_torch_trace.py`` and
``scripts/profile_torch_serve.py``: the device's busy time is the union of
its kernel, memcpy and memset intervals; a kernel is named by its function
name alone; and the card's idle gaps are attributed to the top-level host
ranges that cover them, on any thread, with what no range covers as
``_no_host_op_``. The window is the harness's ``bench.window`` range, which
frames the rest and is itself left out of the attribution, so the gaps fall
to the harness's spans (``bench.feed``, ``bench.step``, ``bench.readback``,
...) or to no host op.
"""

from __future__ import annotations

import bisect
import gzip
import json
import re
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
NO_HOST_OP = "_no_host_op_"


def union(spans) -> List[List[float]]:
    """The (start, end) intervals merged into disjoint ones, in order."""
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def kernel_name(name: str) -> str:
    """A kernel's function name without its return type, anonymous
    namespaces, template arguments and parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                 "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def overlap(spans, starts, lo, hi) -> float:
    """Length of [lo, hi) inside the disjoint sorted ``spans``."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while i < len(spans) and spans[i][0] < hi:
        total += max(0.0, min(hi, spans[i][1]) - max(lo, spans[i][0]))
        i += 1
    return total


def top_level(host) -> Dict[tuple, List[Tuple[float, float, str]]]:
    """Each thread's top-level (start, end, name) ranges."""
    by_thread: Dict[tuple, list] = {}
    for e in host:
        by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
    tops = {}
    for key, evs in by_thread.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = float("-inf")
        out = []
        for e in evs:
            s, d = e["ts"], e["dur"]
            if s >= end:
                out.append((s, s + d, e["name"]))
                end = s + d
        tops[key] = out
    return tops


def load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def summarize(events: list) -> dict:
    """Times in seconds: ``window_s`` (the ``bench.window`` range),
    ``busy_s`` (device busy inside it), ``kernels`` {name: [s, launches]},
    ``spans`` {host range name: [s, count]} of the ``bench.*`` ranges,
    ``gaps`` {top-level host range or ``_no_host_op_``: idle s}."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"] == WINDOW]
    if not win:
        raise ValueError(f"no {WINDOW} range in the trace")
    lo = min(e["ts"] for e in win)
    hi = max(e["ts"] + e["dur"] for e in win)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e["name"] != WINDOW and lo <= e["ts"] < hi]
    busy = union((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                 for e in dev)
    busy_us = sum(e - s for s, e in busy)
    kernels: Dict[str, list] = {}
    for e in dev:
        if e["cat"] == "kernel":
            k = kernels.setdefault(kernel_name(e["name"]), [0.0, 0])
            k[0] += e["dur"] / 1e6
            k[1] += 1
    spans: Dict[str, list] = {}
    for e in host:
        if e["name"].startswith("bench."):
            sp = spans.setdefault(e["name"], [0.0, 0])
            sp[0] += e["dur"] / 1e6
            sp[1] += 1
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    idle_us = sum(e - s for s, e in gaps)
    starts = [s for s, _ in gaps]
    tops = top_level(host)
    in_gaps: Dict[str, float] = {}
    for ranges in tops.values():
        for s, e, name in ranges:
            o = overlap(gaps, starts, s, e)
            if o:
                in_gaps[name] = in_gaps.get(name, 0.0) + o / 1e6
    covered = sum(overlap(gaps, starts, s, e) for s, e in union(
        (s, e) for ranges in tops.values() for s, e, _ in ranges))
    in_gaps[NO_HOST_OP] = (idle_us - covered) / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "kernels": kernels, "spans": spans, "gaps": in_gaps}


def breakdown(summary: dict, n: int = 10) -> dict:
    """The ``n`` device operations with the most time and the ``n``
    longest idle attributions, as [name, seconds]."""
    ops = sorted(((k, v[0]) for k, v in summary["kernels"].items()),
                 key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps if v > 0]}
