"""95th percentile of the traced serve window's requests, from the
hand-over to the device feed until the logits are on the host. The stream
is a closed loop at the system's capacity, so the tail follows the rate
and the host's staging copy in the feed."""

from benchmark.readers import batch_p95_ms


def read(ctx):
    return batch_p95_ms(ctx)
