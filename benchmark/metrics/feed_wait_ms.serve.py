"""Host ms per serve step blocked in the device feed's next()
(data/device_prefetch.py), from the harness's bench.feed spans."""

from benchmark.readers import feed_wait_ms


def read(ctx):
    return feed_wait_ms(ctx)
