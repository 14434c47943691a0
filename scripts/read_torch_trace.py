#!/usr/bin/env python3
"""What a trace of the trainer's ``COVA_PROFILE_DIR`` hook says.

    python3 scripts/read_torch_trace.py TRACE

TRACE is a file the hook wrote (``rank<r>.<ns>.pt.trace.json.gz``, the
Chrome trace of ``torch.profiler``) or its directory, where the newest
rank-0 file is read. Prints one JSON line:

* ``window_ms``: the traced window, from the first host or device event to
  the end of the last one; ``steps``: the train steps in it, counted as
  ``train_step``'s host ranges (``cova_tpu_torch.train_step``: one a step,
  eager or a CUDA graph's replay);
* ``device_busy_ms`` and ``idle_share``: the union of the kernel, memcpy
  and memset intervals (``profile_torch_serve.union``) and the share of the
  window outside it; ``device_ms_by_category`` with
  ``profile_torch_serve.category``; ``kernels``: device ms and launches of
  each kernel by its function name (the 16 with the most time), and
  ``port_kernels`` the same for each of the port's CUDA kernels in it;
* ``host_ops_self_ms``: the host's ops (``aten`` ops, annotated ranges,
  CUDA runtime calls) with the most self time, on all threads;
  ``host_threads``: each thread's top-level ops' busy ms;
* ``device_gaps``: what the host does while the card idles: the idle time
  that each top-level host op covers (the 12 that cover most) and the idle
  time that no host op covers (Python outside torch: the loop's own
  bookkeeping). The device feed's spans are top-level ops here:
  ``cova_tpu_torch.feed.source`` is the wait for ``DataPipeline``'s
  hand-off, ``cova_tpu_torch.feed.stage`` the copy of a batch into pinned
  memory and ``cova_tpu_torch.feed.h2d`` the enqueue of its copies to the
  card;
* ``port_ranges``: host ms and count of each of the port's
  ``cova_tpu_torch.*`` ranges (``utils/tracing.py``), nested ones too;
  ``counters``: what the port's counters added over the traced epoch (the
  trace's ``cova_tpu_torch.counters`` metadata), or null in a trace
  without it.

Every ``*_ms`` also comes divided by the steps, under ``per_step``.
``steady`` leaves out the first step (a new process's first steps also
pay for cuDNN's plan search, the allocator's growth and the step graphs'
captures): from the end of the first step's range to the end of the last,
the device's busy ms a step and idle share, and the step times (range end
to range end) as median, least and most. A step's range ends when the host
has launched its work (a replayed step: one graph launch). The ranges of
the steps and of their graph runs (every ``cova_tpu_torch.*`` range but the
feed's) are left out of the host ops, so the gaps still name the ops
inside them.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from profile_torch_serve import category, union  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STEP_RANGE = "cova_tpu_torch.train_step"  # train/steps.py:STEP_RANGE
PORT = "cova_tpu_torch."  # the port's ranges (utils/tracing.py)
FEED = "cova_tpu_torch.feed."  # data/device_prefetch.py's ranges
COUNTERS_KEY = "cova_tpu_torch.counters"  # train/trainer.py:COUNTERS_KEY
PORT_KERNELS = (  # the __global__ functions of cova_tpu_torch/csrc
    "roi_pool_pyramid_kernel", "roi_pool_bins_kernel",
    "roi_pool_bounds_kernel", "roi_pool_bwd_kernel",
    "bn_relu_pool_fwd_kernel", "bn_relu_pool_bwd_kernel",
    "conv3x3_fwd_bf16_kernel", "conv3x3_fwd_f32_kernel",
    "conv3x3_roll_fwd_bf16_kernel", "conv3x3_roll_fwd_f32_kernel",
    "bn_act_kernel")


def trace_file(path: str) -> str:
    """``path`` itself, or the newest rank-0 trace in the directory."""
    if not os.path.isdir(path):
        return path
    found = sorted(glob.glob(os.path.join(path, "rank0.*.pt.trace.json*")),
                   key=os.path.getmtime)
    if not found:
        raise SystemExit(f"read_torch_trace: no rank0 trace in {path}")
    return found[-1]


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def load_events(trace: dict):
    """The complete ('X') events of a loaded trace."""
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def stepping(e) -> bool:
    """A range of a step or of its graph run: one of the port's ranges
    other than the feed's."""
    return e["name"].startswith(PORT) and not e["name"].startswith(FEED)


def kernel_name(name: str) -> str:
    """A kernel's function name without its return type, anonymous
    namespaces, template arguments and parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                 "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def nest(host):
    """Self time by op name over all threads, and each thread's top-level
    (start, end) intervals with their names."""
    self_us, top = {}, {}
    by_thread = {}
    for e in host:
        by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
    for key, evs in by_thread.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack, tops = [], []
        for e in evs:
            s, d = e["ts"], e["dur"]
            while stack and stack[-1][1] <= s:
                stack.pop()
            self_us[e["name"]] = self_us.get(e["name"], 0.0) + d
            if stack:
                parent = stack[-1][2]
                self_us[parent] -= min(d, stack[-1][1] - s)
            else:
                tops.append((s, s + d, e["name"]))
            stack.append((s, s + d, e["name"]))
        top[key] = tops
    return self_us, top


def overlap(spans, starts, lo, hi):
    """Length of [lo, hi) inside the disjoint sorted ``spans`` (``starts``:
    their start points)."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while i < len(spans) and spans[i][0] < hi:
        total += max(0.0, min(hi, spans[i][1]) - max(lo, spans[i][0]))
        i += 1
    return total


def read_trace(path: str) -> dict:
    path = trace_file(path)
    trace = load_trace(path)
    events = load_events(trace)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    both = dev + host
    lo = min(e["ts"] for e in both)
    hi = max(e["ts"] + e["dur"] for e in both)
    window = hi - lo
    step_ends = sorted(e["ts"] + e["dur"] for e in host
                       if e["name"] == STEP_RANGE
                       and e.get("cat") == "user_annotation")
    steps = len(step_ends)

    busy = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    by_cat, kernels = {}, {}
    for e in dev:
        c = category(e["name"])
        by_cat[c] = by_cat.get(c, 0.0) + e["dur"]
        if e["cat"] == "kernel":
            k = kernels.setdefault(kernel_name(e["name"]), [0.0, 0])
            k[0] += e["dur"]
            k[1] += 1

    self_us, top = nest([e for e in host if not stepping(e)])
    port = {}
    for e in host:
        if e["name"].startswith(PORT):
            r = port.setdefault(e["name"], [0.0, 0])
            r[0] += e["dur"]
            r[1] += 1
    # The card's idle intervals inside the window, and which top-level
    # host ops run during them.
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    idle_us = sum(e - s for s, e in gaps)
    starts = [s for s, _ in gaps]
    in_gaps = {}
    for tops in top.values():
        for s, e, name in tops:
            o = overlap(gaps, starts, s, e)
            if o:
                in_gaps[name] = in_gaps.get(name, 0.0) + o
    all_tops = union((s, e) for tops in top.values() for s, e, _ in tops)
    covered = sum(overlap(gaps, starts, s, e) for s, e in all_tops)

    def ms(us):
        return us / 1e3

    def top_n(d, n):
        return sorted(d.items(), key=lambda kv: -kv[1])[:n]

    out = {
        "trace": os.path.basename(path),
        "events": len(events), "device_events": len(dev),
        "window_ms": ms(window), "steps": steps,
        "device_busy_ms": ms(busy_us),
        "idle_share": 1.0 - busy_us / window if window else None,
        "device_ms_by_category": {k: ms(v) for k, v in top_n(by_cat, 99)},
        "kernels": {k: {"ms": ms(v[0]), "launches": v[1]}
                    for k, v in sorted(kernels.items(),
                                       key=lambda kv: -kv[1][0])[:16]},
        "port_kernels": {k: {"ms": ms(v[0]), "launches": v[1]}
                         for k, v in kernels.items() if k in PORT_KERNELS},
        "host_ops_self_ms": [[k, ms(v)] for k, v in top_n(self_us, 16)],
        "host_threads": [
            {"tid": tid, "top_level_ops": len(tops),
             "busy_ms": ms(sum(e - s for s, e in union(
                 (s, e) for s, e, _ in tops)))}
            for (_, tid), tops in sorted(top.items(),
                                         key=lambda kv: -len(kv[1]))],
        "device_gaps": {
            "idle_ms": ms(idle_us), "gaps": len(gaps),
            "no_host_op_ms": ms(idle_us - covered),
            "by_top_level_host_op_ms": [[k, ms(v)]
                                        for k, v in top_n(in_gaps, 12)]},
        "port_ranges": {k: {"ms": ms(v[0]), "calls": v[1]}
                        for k, v in sorted(port.items())},
        "counters": trace.get(COUNTERS_KEY),
    }
    if steps:
        out["per_step"] = {
            "window_ms": ms(window) / steps,
            "device_busy_ms": ms(busy_us) / steps,
            "idle_ms": ms(idle_us) / steps,
            "no_host_op_ms": ms(idle_us - covered) / steps,
            "device_ms_by_category": {k: ms(v) / steps
                                      for k, v in top_n(by_cat, 99)}}
    if steps >= 3:
        a, b = step_ends[0], step_ends[-1]
        s_busy = overlap(busy, [s for s, _ in busy], a, b)
        step_ms = [ms(y - x) for x, y in zip(step_ends, step_ends[1:])]
        out["steady"] = {
            "steps": steps - 1, "window_ms": ms(b - a),
            "device_busy_ms_per_step": ms(s_busy) / (steps - 1),
            "idle_share": 1.0 - s_busy / (b - a),
            "step_ms_median": statistics.median(step_ms),
            "step_ms_min": min(step_ms), "step_ms_max": max(step_ms)}
    return out


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(read_trace(argv[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
