"""Device ms per serve step in PyTorch's LayerNorm kernels
(at::native::vectorized_layer_norm_kernel, or the generic
LayerNormForwardCUDAKernel): the Swin trunk's six LayerNorms a batch, from
the trace. Nothing to read in a trunk without LayerNorms."""

from benchmark.readers import kernel_seconds


def _layer_norm(name: str) -> bool:
    name = name.lower()
    return "layer_norm" in name or "layernorm" in name


def read(ctx):
    if not ctx["steps"]:
        return None
    got = kernel_seconds(ctx, _layer_norm)
    return None if got is None else got[0] / ctx["steps"] * 1e3
