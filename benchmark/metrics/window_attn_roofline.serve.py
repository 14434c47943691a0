"""The Swin trunk's shifted-window attention, K10 (ops/window_attn.py,
csrc/window_attn.cu): the bytes bound's share of its device time. The
bytes are the trunk file's ``window_attn_bytes``
(reference/trunks/<backbone>.py); a trunk whose file has none gives
nothing to read."""

from benchmark.readers import roofline
from benchmark.reference.cova import trunk

KERNELS = ("window_attn_kernel",)


def read(ctx):
    nbytes = getattr(trunk(ctx["config"]), "window_attn_bytes", None)
    return None if nbytes is None else roofline(ctx, KERNELS, nbytes)
