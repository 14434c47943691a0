"""The port's host spans and counters.

* ``span(name)``: a ``torch.profiler.record_function`` range named
  ``name`` while a profiler records this thread, so the range lands in the
  trace beside the card's kernels and copies, on their clock. Without a
  profiler it is one shared no-op context: a flag check, nothing
  allocated. Names are ``cova_tpu_torch.<layer>.<what>``. A span opens and
  closes without a ``yield`` inside it, and none sits inside a step that a
  CUDA graph captures.
* ``count(key, n)``: one flat registry of counters, always on.
  ``counters()`` returns them with the kernel launches of
  ``ops/launches.py`` as ``launches.<kernel>``; ``since(before)`` what was
  added since a ``counters()``.
* ``traced()``: what spans and counts recorded while a profiler recorded
  their thread: each span's host seconds (``<name>.s``) and entries
  (``<name>.calls``), and each count made then (``<key>``). Whoever runs
  the profiler over a window reads its spans' totals and counts here,
  without the trace.

The spans and counters, and what reads them: ``PERF.md`` §3.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
_lock = threading.Lock()  # the feed's and the steps' threads may differ
_counts: Dict[str, int] = {}
_traced: Dict[str, float] = {}


class _Span:
    """A ``record_function`` range that adds its host seconds to
    ``traced()``."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        with _lock:
            _add(_traced, self.name + ".s", dt)
            _add(_traced, self.name + ".calls", 1)


def _add(registry: dict, key: str, n) -> None:
    registry[key] = registry.get(key, 0) + n


def span(name: str):
    """A profiler range named ``name`` while a profiler records this
    thread, else a no-op context."""
    if _recording():
        return _Span(name)
    return _OFF


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` (and to ``traced()`` while a profiler
    records this thread)."""
    recording = _recording()
    with _lock:
        _add(_counts, key, n)
        if recording:
            _add(_traced, key, n)


def counters() -> Dict[str, int]:
    """Every counter, and each kernel's launches as ``launches.<kernel>``."""
    from ..ops import launches

    with _lock:
        out = dict(_counts)
    out.update((f"launches.{k}", n) for k, n in launches.counts().items())
    return out


def traced() -> Dict[str, float]:
    """The spans' host seconds and entries, and the counts, recorded while
    a profiler recorded their thread, over the process's life."""
    with _lock:
        return dict(_traced)


def since(before: Dict[str, float],
          now: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """``now`` (default: ``counters()``) less ``before``, key by key."""
    now = counters() if now is None else now
    return {k: v - before.get(k, 0) for k, v in now.items()}
