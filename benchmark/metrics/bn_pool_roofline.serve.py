"""Stem BN-ReLU-max-pool forward, K5 (ops/bn_pool.py, csrc/bn_pool.cu):
the bytes bound's share of its device time."""

from benchmark.counts import bn_pool_bytes
from benchmark.readers import roofline

KERNELS = ("bn_relu_pool_fwd_kernel",)


def read(ctx):
    return roofline(ctx, KERNELS, bn_pool_bytes)
