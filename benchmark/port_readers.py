"""The per-layer readers of the port's own spans and counters.

While the harness's profiler records the window, the port's spans
(``cova_tpu_torch/utils/tracing.py``) add their host seconds and entries,
and its counters their counts, to ``tracing.traced()``. The profiler
records the window alone, and a run is one process, so those totals are
the window's. A port without that module, or a span or counter that did
not run, gives nothing to read.

``program.py`` drives the port; this module only reads its record.
"""

from __future__ import annotations

from typing import Optional


def traced() -> Optional[dict]:
    """The port's ``tracing.traced()``, or None where the port has no such
    record."""
    try:
        from cova_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.traced()


def span_ms(ctx: dict, name: str, record: Optional[dict]) -> Optional[float]:
    """Host ms per step in the port's span ``name`` over the traced
    window."""
    if ctx["summary"] is None or not ctx["steps"] or record is None:
        return None
    s = record.get(name + ".s")
    return None if s is None else s / ctx["steps"] * 1e3


def replay_pct(ctx: dict, kind: str,
               record: Optional[dict]) -> Optional[float]:
    """Percent of the traced window's step-graph runs of ``kind`` that
    were replays, of its eager runs, captures and replays."""
    if ctx["summary"] is None or record is None:
        return None
    runs = {k: record.get(f"graph.{k}.{kind}", 0)
            for k in ("eager", "captures", "replays")}
    total = sum(runs.values())
    return 100.0 * runs["replays"] / total if total else None
