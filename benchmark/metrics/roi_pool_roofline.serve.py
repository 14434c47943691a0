"""RoI max-pool forward, K1 (ops/roi_pool.py, csrc/roi_pool.cu: the
pyramid and bins kernels): the bytes bound's share of their device time."""

from benchmark.counts import roi_pool_bytes
from benchmark.readers import roofline

KERNELS = ("roi_pool_pyramid_kernel", "roi_pool_bins_kernel")


def read(ctx):
    return roofline(ctx, KERNELS, roi_pool_bytes)
