"""What the per-layer readers in ``metrics/`` share.

A reader gets the run's context (``harness.reader_context``) and returns
its value, or None where the run gives it nothing to read: no trace, or
a kernel it sums that did not run.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from . import counts


def feed_wait_ms(ctx: dict) -> Optional[float]:
    """Host ms per step in the feed's ``next()`` (the ``bench.feed``
    spans of the trace)."""
    if ctx["summary"] is None or not ctx["steps"]:
        return None
    span = ctx["summary"]["spans"].get("bench.feed")
    if span is None:
        return None
    return span[0] / ctx["steps"] * 1e3


def mfu(ctx: dict) -> Optional[float]:
    """The model's FLOPs of the pages done over the window's seconds, as a
    percentage of the card's dense bf16 peak."""
    if not ctx["steps"]:
        return None
    cfg = ctx["config"]
    flops = sum(counts.step_flops(cfg, ctx["shapes"](j)["valid"]) * n
                for j, n in ctx["step_counts"].items())
    return 100.0 * flops / ctx["window_s"] / counts.PEAK_BF16_FLOPS


def kernel_seconds(ctx: dict, match: Callable[[str], bool]):
    """Device seconds and launches of the trace's kernels whose name
    ``match`` accepts; None where no such kernel ran."""
    if ctx["summary"] is None:
        return None
    hits = [v for k, v in ctx["summary"]["kernels"].items() if match(k)]
    if not hits:
        return None
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def elementwise_ms(ctx: dict) -> Optional[float]:
    """Device ms per step in PyTorch's elementwise kernels."""
    if not ctx["steps"]:
        return None
    got = kernel_seconds(ctx, lambda k: "elementwise_kernel" in k)
    return None if got is None else got[0] / ctx["steps"] * 1e3


def roofline(ctx: dict, kernels: Sequence[str], nbytes) -> Optional[float]:
    """The bytes bound's share of the kernels' device time, in percent:
    the bytes of every step of the window (``nbytes(shapes)`` for each
    batch run) at the HBM peak, over the device time of the kernels
    named in ``kernels``."""
    if not ctx["steps"]:
        return None
    got = kernel_seconds(ctx, lambda k: k in kernels)
    if got is None or got[0] <= 0:
        return None
    total = sum(nbytes(ctx["shapes"](j)) * n
                for j, n in ctx["step_counts"].items())
    return 100.0 * counts.bound_seconds(total) / got[0]


def device_idle(ctx: dict) -> Optional[float]:
    """Percent of the traced window that no kernel, memcpy or memset
    covers; None where the trace holds no device work at all."""
    s = ctx["summary"]
    if s is None or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def batch_p95_ms(ctx: dict) -> Optional[float]:
    """95th percentile of the traced window's request latencies (hand-over
    to the feed until the logits are on the host), in ms."""
    lat = ctx.get("latencies_s") or []
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
