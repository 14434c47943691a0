"""Host ms per serve step in the device feed's staging copy: the port's
cova_tpu_torch.feed.stage span (data/device_prefetch.py), every field of
a batch copied into the pinned rings, with the wait for a ring slot."""

from benchmark.port_readers import span_ms, traced


def read(ctx):
    return span_ms(ctx, "cova_tpu_torch.feed.stage", traced())
