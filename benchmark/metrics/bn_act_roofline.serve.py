"""The trunk blocks' eval-mode BN + residual + ReLU, K9 (ops/bn_act.py,
csrc/bn_act.cu): the bytes bound's share of its device time. The bytes
are the trunk file's ``bn_act_bytes`` (reference/trunks/<backbone>.py);
a trunk whose file has none gives nothing to read."""

from benchmark.readers import roofline
from benchmark.reference.cova import trunk

KERNELS = ("bn_act_kernel",)


def read(ctx):
    nbytes = getattr(trunk(ctx["config"]), "bn_act_bytes", None)
    return None if nbytes is None else roofline(ctx, KERNELS, nbytes)
