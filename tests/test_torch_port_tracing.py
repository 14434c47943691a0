"""The port's spans and counters (``cova_tpu_torch/utils/tracing.py``) and
the device feed's (``data/device_prefetch.py``): a span is a profiler range
only while a profiler records, the counters add up and read the kernel
launch counts through, ``traced()`` keeps what was recorded under a
profiler, and the feed's spans and counters follow its batches. The feed's
staging on the card is held by the test marked ``cuda``."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cova_tpu_torch.data.batching import Batch
from cova_tpu_torch.data.device_prefetch import device_prefetch
from cova_tpu_torch.ops import launches, roi_pool
from cova_tpu_torch.utils import tracing


def _ranges(prof, prefix="cova_tpu_torch."):
    """The names of the profiler's host ranges that start with
    ``prefix``, in order."""
    return [e.name for e in prof.events() if e.name.startswith(prefix)
            and e.device_type == DeviceType.CPU]


def _batches(n, b=2, p=8):
    rng = np.random.default_rng(0)
    return [(i, Batch(
        images=rng.integers(0, 255, (b, 4, 4, 48), dtype=np.uint8),
        boxes=rng.random((b, p, 4), dtype=np.float32),
        labels=rng.integers(0, 4, (b, p), dtype=np.int32),
        box_mask=np.ones((b, p), bool),
        context_indices=rng.integers(-1, p, (b, p, 4), dtype=np.int32),
        additional_feats=np.zeros((b, p, 0), np.float32)))
        for i in range(n)]


def test_a_span_is_a_range_only_under_a_profiler():
    with tracing.span("cova_tpu_torch.test.off") as got:
        assert got is None
    # Without a profiler every span is the same no-op object.
    assert tracing.span("a") is tracing.span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("cova_tpu_torch.test.outer"):
            with tracing.span("cova_tpu_torch.test.inner"):
                torch.ones(2).sum()
    assert _ranges(prof) == ["cova_tpu_torch.test.outer",
                             "cova_tpu_torch.test.inner"]
    assert "cova_tpu_torch.test.off" not in _ranges(prof)


def test_counters_and_since_read_the_launches_through():
    before = tracing.counters()
    tracing.count("test.things")
    tracing.count("test.things", 4)
    tracing.count("test.bytes", 10)
    roi_pool.roi_pool.launches += 3
    try:
        now = tracing.counters()
        got = tracing.since(before)
        assert got["test.things"] == 5 and got["test.bytes"] == 10
        assert got["launches.roi_pool_fwd"] == 3
        assert now["launches.roi_pool_fwd"] == launches.counts()[
            "roi_pool_fwd"]
        assert {k for k in now if k.startswith("launches.")} == {
            "launches." + k for k in launches.WRAPPERS}
        assert got["launches.bn_relu_pool_fwd"] == 0
    finally:
        roi_pool.roi_pool.launches -= 3


def test_traced_keeps_what_ran_under_a_profiler():
    before = tracing.traced()
    with tracing.span("cova_tpu_torch.test.quiet"):
        tracing.count("test.quiet")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tracing.span("cova_tpu_torch.test.loud"):
                tracing.count("test.loud", 2)
    got = tracing.since(before, tracing.traced())
    assert got["cova_tpu_torch.test.loud.calls"] == 3
    assert got["cova_tpu_torch.test.loud.s"] > 0
    assert got["test.loud"] == 6
    assert "cova_tpu_torch.test.quiet.calls" not in got
    assert "test.quiet" not in got


def test_feed_on_the_cpu_counts_and_spans_its_batches():
    items = _batches(3)
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(device_prefetch(iter(items), "cpu"))
    assert [ids for ids, _, _ in got] == [0, 1, 2]
    assert all(on is batch for _, batch, on in got)
    moved = tracing.since(before)
    assert moved["feed.batches"] == 3
    assert moved.get("feed.bytes_staged", 0) == 0
    # One wait on the upstream a batch, and one more for its end; nothing
    # is staged on the CPU.
    assert _ranges(prof, "cova_tpu_torch.feed.") == [
        "cova_tpu_torch.feed.source"] * 4


@pytest.mark.cuda
def test_feed_on_the_card_traced_equals_untraced():
    """Three batches through the feed on the card, traced and not: the same
    tensors; under the profiler each staging span once a batch, the wait on
    the upstream once a batch and once for its end; ``feed.bytes_staged``
    the batches' bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the feed stages only for CUDA")
    items = _batches(3, b=4, p=32)
    plain = [[t.cpu() for t in on]
             for _, _, on in device_prefetch(iter(items), "cuda")]
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = [[t.cpu() for t in on]
                  for _, _, on in device_prefetch(iter(items), "cuda")]
    for a, b in zip(plain, traced):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for (_, batch), got in zip(items, traced):
        for arr, t in zip(batch, got):
            assert torch.equal(t, torch.from_numpy(arr))
    names = _ranges(prof, "cova_tpu_torch.feed.")
    assert names.count("cova_tpu_torch.feed.source") == 4
    assert names.count("cova_tpu_torch.feed.stage") == 3
    assert names.count("cova_tpu_torch.feed.h2d") == 3
    moved = tracing.since(before)
    assert moved["feed.batches"] == 3
    assert moved["feed.bytes_staged"] == sum(
        arr.nbytes for _, batch in items for arr in batch)
