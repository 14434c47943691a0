"""Device prefetch: overlap the host-to-device copy of the next batch with
the current step's compute.

Counterpart of ``cova_tpu/data/device_prefetch.py``, where ``jax.device_put``
is asynchronous by itself. Here each batch is copied into pinned staging
buffers that are reused from batch to batch (no pinned allocation per
step), sent to the device with ``non_blocking=True`` on a side stream, and
handed over behind an event: the consumer's stream waits for the copy, the
host does not. Up to ``size`` batches are in flight. On a CPU device the
batches pass through untouched.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from .batching import Batch


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
        if slot[1] is not None:
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
    try:
        if device.type != "cuda":
            for ids, batch in it:
                yield ids, batch, batch
            return
        side = torch.cuda.Stream(device)
        staging = _Staging(size + 1)
        queue: deque = deque()

        def put(item) -> None:
            ids, batch = item
            tensors: List[torch.Tensor] = []
            with torch.cuda.stream(side):
                slots = []
                for name, arr in zip(Batch._fields, batch):
                    host, slot = staging.fill(name, arr)
                    tensors.append(host.to(device, non_blocking=True))
                    slots.append(slot)
                done = torch.cuda.Event()
                done.record(side)
            for slot in slots:
                slot[1] = done
            queue.append((ids, batch, Batch(*tensors), done))

        def take():
            ids, batch, on_device, done = queue.popleft()
            cur = torch.cuda.current_stream(device)
            cur.wait_event(done)
            for t in on_device:
                t.record_stream(cur)  # allocated on the side stream
            return ids, batch, on_device

        for item in it:
            put(item)
            if len(queue) > size:
                yield take()
        while queue:
            yield take()
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
