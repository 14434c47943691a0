"""Device ms per serve step in PyTorch's elementwise kernels
(at::native::*elementwise_kernel: MaskedBatchNorm's passes, ReLUs, adds,
casts), from the trace."""

from benchmark.readers import elementwise_ms


def read(ctx):
    return elementwise_ms(ctx)
