"""One run of one cell: set-up, the timed window, the check, the result.

Set-up makes the pool of pages and the weights from the seed, builds the
port's host batches and model, and drives the port's feed and steps over
the pool twice, so that every box bucket of the pool has had its eager
step and its graph capture before the window opens.

The window cycles over the pool for ``seconds``, handing each host batch
to the port's device feed: a closed loop of one stream, a request being
one batch from its hand-over to the feed until its logits are read on the
host as numpy. Each step's logits are copied to pinned host memory behind
an event and read the mix's ``readback_lag`` steps later, so the host
stages the next batches while the card computes. When the time is up no
batch is handed over, every step sent is read, and then the clock is
read. The harness's spans (``bench.window``, ``bench.feed``,
``bench.step``, ``bench.readback``) frame the calls.

After the window the peak device memory is read, the program's state is
freed, and the plain reference runs on the same pages and weights.
"""

from __future__ import annotations

import collections
import gc
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import check, counts, pages, weights as weights_mod
from . import trace as tracing
from .reference import cova as reference


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Window:
    """The per-run quantities the window records."""

    def __init__(self):
        self.steps = 0
        self.pages = 0
        self.seconds = 0.0
        self.step_counts: Dict[int, int] = collections.Counter()
        self.latencies_s: List[float] = []
        self.done_s: List[float] = []  # each request's end, from the start
        self.host_s: Dict[str, float] = {}  # host seconds in each call


def _next(it):
    with record_function("bench.feed"):
        return next(it, None)


class _Answers:
    """Each step's logits copied to the host behind an event on the
    card's stream, and read ``lag`` steps later: the host goes on staging
    and dispatching while the card works. Pinned buffers are kept by shape
    and reused; on a CPU device the copy is plain."""

    def __init__(self, dev: torch.device, lag: int):
        self.dev, self.lag = dev, lag
        self.free: Dict[tuple, List[torch.Tensor]] = {}
        self.pending: collections.deque = collections.deque()

    def reserve(self, shape: tuple, n: int) -> None:
        """At least ``n`` free buffers for logits of ``shape``."""
        bufs = self.free.setdefault(tuple(shape), [])
        while len(bufs) < n:
            bufs.append(torch.empty(shape, dtype=torch.float32,
                                    pin_memory=self.dev.type == "cuda"))

    def put(self, key, logits: torch.Tensor) -> None:
        shape = tuple(logits.shape)
        self.reserve(shape, 1)
        buf = self.free[shape].pop()
        done = None
        if self.dev.type == "cuda":
            buf.copy_(logits, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.dev))
        else:
            buf.copy_(logits)
        self.pending.append((key, buf, done))

    def due(self, drain: bool = False):
        """The (key, logits as numpy) of the steps read now: all but the
        newest ``lag``, or all of them with ``drain``."""
        while self.pending and (drain or len(self.pending) > self.lag):
            key, buf, done = self.pending.popleft()
            with record_function("bench.readback"):
                if done is not None:
                    done.synchronize()
                arr = buf.numpy().copy()
            self.free[tuple(buf.shape)].append(buf)
            yield key, arr


def _serve(prog, cfg, traffic, pool, w, seconds, dev, start, mark):
    nb = len(pool.batches)
    host = [prog.host_batch(pool.batch_pages(j), cfg) for j in range(nb)]
    mark("host batches")
    model = prog.build_model(cfg, w, dev)
    mark("model")
    lag = traffic.get("readback_lag", 0)
    schedule = list(range(nb)) * 2
    shapes = set()
    for step, (_, _, batch) in enumerate(prog.feed(
            ((j, host[j]) for j in schedule), dev, traffic["prefetch"]), 1):
        shapes.add(tuple(prog.serve(model, batch).cpu().shape))
        if step == 1:
            mark("first step")
    _sync(dev)
    out = _Answers(dev, lag)
    for shape in shapes:
        out.reserve(shape, lag + 1)  # the steps in flight and one more
    mark("warm-up steps")
    start()
    win = _Window()
    answers = []
    handed: Dict[int, float] = {}
    host_s = collections.Counter()
    t0 = time.perf_counter()
    end = t0 + seconds

    def items():
        k = 0
        while time.perf_counter() < end:
            handed[k] = time.perf_counter()
            yield (k, k % nb), host[k % nb]
            k += 1

    def land(drain=False):
        t = time.perf_counter()
        for (k, j), arr in out.due(drain):
            now = time.perf_counter()
            win.latencies_s.append(now - handed.pop(k))
            win.done_s.append(now - t0)
            answers.append((j, arr))
            win.steps += 1
            win.pages += traffic["batch_size"]
            win.step_counts[j] += 1
        host_s["readback"] += time.perf_counter() - t

    with record_function("bench.window"):
        it = iter(prog.feed(items(), dev, traffic["prefetch"]))
        while True:
            t = time.perf_counter()
            item = _next(it)
            host_s["feed"] += time.perf_counter() - t
            if item is None:
                break
            key, _, batch = item
            t = time.perf_counter()
            with record_function("bench.step"):
                out.put(key, prog.serve(model, batch))
            host_s["step"] += time.perf_counter() - t
            land()
        land(drain=True)
    win.seconds = time.perf_counter() - t0
    win.host_s = dict(host_s)

    def verify():
        ref = reference.serve(w, [pool.batch_pages(j) for j in range(nb)],
                              cfg, dev)
        valid = [[len(pg["labels"]) for pg in pool.batch_pages(j)]
                 for j in range(nb)]
        return check.serve_numbers(answers, ref, valid)

    return win, [model, it, out], verify


def end_to_end(win: _Window, setup_s: float) -> Dict[str, float]:
    """The values of the end-to-end metrics a run measures."""
    return {"setup_s": setup_s,
            "serve_pages_per_s": win.pages / win.seconds}


def run_cell(cell: dict, cfg: dict, traffic: dict, limits: dict,
             seed: int, seconds: float, traced: bool, device,
             t_start: float, metrics: dict,
             readers: Optional[Dict[str, Callable]] = None) -> tuple:
    """One run. ``metrics``: the end-to-end and per-layer entries of
    BENCHMARK.json (name -> entry); ``readers``: name -> read(ctx) of the
    per-layer metrics of this cell. Returns the result dict, the lines for
    standard error and the check's numbers."""
    from . import program as prog  # the system under test

    dev = torch.device(device)
    marks = [("start", t_start)]  # (set-up phase, host clock at its end)

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))

    mark("imports")
    pool = pages.make_pool(traffic, cfg, seed, dev)
    mark("pages")
    w = weights_mod.make_weights(cfg, seed, dev)
    mark("weights")
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

    t_window = [None]

    def start():
        if prof is not None:
            prof.__enter__()
        t_window[0] = time.perf_counter()

    win, held, verify = _serve(
        prog, cfg, traffic, pool, w, seconds, dev, start, mark)
    setup_s = t_window[0] - t_start
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            summary = tracing.summarize(tracing.load(path))
        finally:
            os.remove(path)
        del prof
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del held
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = verify()
    correct, checks = check.judge(numbers, limits)
    values = end_to_end(win, setup_s)
    result_metrics = {}
    ctx = (reader_context(cfg, pool, win, summary)
           if traced else None)
    for name, entry in metrics.items():
        listed = entry.get("workloads")
        if listed is not None and cell["name"] not in listed:
            continue
        if not traced and "bound" in entry and name in values:
            result_metrics[name] = {"value": values[name],
                                    "unit": entry["unit"]}
        if traced and "bound" not in entry and readers and name in readers:
            v = readers[name](ctx)
            if v is not None:
                result_metrics[name] = {"value": v, "unit": entry["unit"]}
    failed = 0
    if not correct:
        per = {"logit_err": "errs", "logit_rel": "rels"}
        failed = max(1, sum(
            1 for k in range(len(numbers["errs"]))
            if any(not numbers[per[n]][k] <= lim
                   for n, lim in limits.items() if n in per)))
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
    result = {"correct": bool(correct), "attempted": win.steps,
              "failed": failed, "metrics": result_metrics,
              "device": dev_info}
    if summary is not None:
        result["breakdown"] = tracing.breakdown(summary)
    result["checks"] = checks
    phases = ", ".join(f"{name} {t - t0:.3f} s" for (_, t0), (name, t)
                       in zip(marks, marks[1:]))
    lines = [f"set-up: {phases}"]
    lines += [f"window: {win.steps} steps, {win.pages} pages in "
             f"{win.seconds:.6f} s; set-up {setup_s:.6f} s"]
    if win.steps:
        lines += ["host ms a step: " + ", ".join(
            f"{k} {v / win.steps * 1e3:.3f}"
            for k, v in sorted(win.host_s.items()))]
    if win.done_s and win.seconds > 0:
        quarter = win.seconds / 4
        per = collections.Counter(min(int(t / quarter), 3)
                                  for t in win.done_s)
        lines += ["window quarters, pages/s: " + ", ".join(
            f"{per[i] * traffic['batch_size'] / quarter:.1f}"
            for i in range(4))]
    lines += [f"{k}: {v}" for k, v in numbers.items()
              if k not in ("errs", "rels") and not isinstance(v, dict)]
    lines += [f"check {k} = {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines, numbers


def reader_context(cfg, pool, win, summary) -> dict:
    """What a per-layer reader reads: the configuration, the window's
    counts, host seconds and request latencies, the trace's summary, and a
    function that gives each pool batch's shapes for the byte counts."""
    cache = {}

    def shapes(j):
        if j not in cache:
            pg = pool.batch_pages(j)
            p = reference.bucket(max(len(x["labels"]) for x in pg), cfg)
            cache[j] = counts.batch_shapes(pg, cfg, p)
        return cache[j]

    return {"config": cfg, "summary": summary,
            "steps": win.steps, "window_s": win.seconds,
            "step_counts": dict(win.step_counts),
            "latencies_s": list(win.latencies_s), "shapes": shapes}
