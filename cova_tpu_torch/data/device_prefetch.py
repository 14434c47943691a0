"""Device prefetch: overlap the host-to-device copy of the next batch with
the current step's compute.

Counterpart of ``cova_tpu/data/device_prefetch.py``, where ``jax.device_put``
is asynchronous by itself. Here each batch is copied into pinned staging
buffers that are reused from batch to batch (no pinned allocation per
step), sent to the device with ``non_blocking=True`` on a side stream, and
handed over behind an event: the consumer's stream waits for the copy, the
host does not. Up to ``size`` batches are in flight. On a CPU device the
batches pass through untouched.

Spans (``utils/tracing.py``): ``cova_tpu_torch.feed.source``, the wait on
the upstream iterator (in ``fit`` and ``predict_pages``, ``DataPipeline``'s
hand-off); ``feed.stage``, a batch's fields copied into the pinned rings,
with ``feed.slot_wait`` inside it where a slot waits for its previous copy;
``feed.h2d``, the non-blocking copies and the event on the side stream.
Counters: ``feed.batches``, ``feed.bytes_staged``, and ``feed.slot_waits``
(a slot whose previous copy had not ended when it was wanted: the host
waits for that copy, inside ``feed.slot_wait``).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from ..utils.tracing import count, span
from .batching import Batch

_END = object()


class _Staging:
    """Rings of pinned host buffers, one ring per (field, shape, dtype).
    A slot is rewritten only after the copy that last read it has ended."""

    def __init__(self, slots: int):
        self.slots = slots
        self.rings = {}

    def fill(self, name: str, arr: np.ndarray) -> Tuple[torch.Tensor, list]:
        """``arr`` copied into the ring's next slot; returns the pinned
        tensor and the slot's record, whose ``[1]`` takes the event of the
        copy that reads it."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        ring = self.rings.setdefault(
            (name, src.shape, src.dtype), {"next": 0, "slots": []})
        if len(ring["slots"]) < self.slots:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            ring["slots"].append([buf, None])
        slot = ring["slots"][ring["next"] % len(ring["slots"])]
        ring["next"] += 1
        if slot[1] is not None and not slot[1].query():
            count("feed.slot_waits")
            with span("cova_tpu_torch.feed.slot_wait"):
                slot[1].synchronize()
        slot[0].copy_(src)
        return slot[0], slot


def device_prefetch(iterator: Iterable, device, size: int = 2) -> Iterator:
    """Yield ``(ids, batch, on_device)`` for every ``(ids, batch)`` of
    ``iterator``: ``batch`` is the host ``Batch`` as it came, ``on_device``
    a ``Batch`` of tensors on ``device`` whose copies were started up to
    ``size`` items ahead. On a CPU device ``on_device`` is ``batch``.
    Closing the generator closes ``iterator``."""
    device = torch.device(device)
    it = iter(iterator)

    def pull():
        with span("cova_tpu_torch.feed.source"):
            item = next(it, _END)
        if item is not _END:
            count("feed.batches")
        return item

    try:
        if device.type != "cuda":
            for ids, batch in iter(pull, _END):
                yield ids, batch, batch
            return
        side = torch.cuda.Stream(device)
        staging = _Staging(size + 1)
        queue: deque = deque()

        def put(item) -> None:
            ids, batch = item
            with span("cova_tpu_torch.feed.stage"):
                staged = [staging.fill(name, arr)
                          for name, arr in zip(Batch._fields, batch)]
            count("feed.bytes_staged", sum(h.nbytes for h, _ in staged))
            with span("cova_tpu_torch.feed.h2d"), torch.cuda.stream(side):
                tensors: List[torch.Tensor] = [
                    host.to(device, non_blocking=True) for host, _ in staged]
                done = torch.cuda.Event()
                done.record(side)
            for _, slot in staged:
                slot[1] = done
            queue.append((ids, batch, Batch(*tensors), done))

        def take():
            ids, batch, on_device, done = queue.popleft()
            cur = torch.cuda.current_stream(device)
            cur.wait_event(done)
            for t in on_device:
                t.record_stream(cur)  # allocated on the side stream
            return ids, batch, on_device

        for item in iter(pull, _END):
            put(item)
            if len(queue) > size:
                yield take()
        while queue:
            yield take()
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
