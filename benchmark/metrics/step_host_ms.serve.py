"""Host ms per serve step in the port's forward_step (its
cova_tpu_torch.forward_step span, train/steps.py): the copies into a
graph's static inputs, the graph launch and the output copies."""

from benchmark.port_readers import span_ms, traced


def read(ctx):
    return span_ms(ctx, "cova_tpu_torch.forward_step", traced())
