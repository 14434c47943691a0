"""The truncated ResNet-18 backbone (``resnet18_stem``), NHWC.

Counterpart of the ``resnet18_stem`` path of ``cova_tpu/models/resnet.py``:
conv1 (7x7/2) -> bn1 -> relu -> maxpool (3x3/2) -> layer1 (two 64-channel
BasicBlocks); output stride 4, 64 channels. Child names follow the
reference's ``nn.Sequential(resnet18.children()[:-5])`` (``0`` conv1, ``1``
bn1, ``4`` layer1; the ReLU and the pool at 2 and 3 have no parameters), so
its state_dict keys load unchanged.

For an s2d(4) input (and RGB whose sides divide by 4) the stem runs the
conv in s2d form (``ops.conv_stem.stem_conv_s2d``), folds the four s2d(2)
phase groups into the BN statistics, and applies normalize + ReLU + pool in
one kernel (``ops.bn_pool.bn_relu_pool_s2d``). Other RGB sizes take the
plain ops. In training the stem's BN coefficients carry gradient (they
depend on ys through the batch statistics) and ``bn_relu_pool_s2d`` runs its
backward kernel. Other backbones wait for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_pool import bn_relu_pool_s2d
from ..ops.conv_stem import nhwc_conv2d, stem_conv_s2d
from .layers import MaskedBatchNorm

# flax's truncated_normal draws within +-2 standard deviations and divides
# the target std by the std of that truncated unit normal.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """``flax.linen.initializers.he_normal()`` for an OIHW conv weight:
    variance 2 / fan_in from a normal truncated at +-2 of its std."""
    fan_in = weight[0].numel()
    std = (2.0 / fan_in) ** 0.5 / _TRUNC_STD
    torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock at stride 1 with no downsample, NHWC, with
    its attribute names (conv1/bn1/conv2/bn2)."""

    def __init__(self, ch: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn1 = MaskedBatchNorm(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(nhwc_conv2d(x, self.conv1.weight, padding=1)))
        y = self.bn2(nhwc_conv2d(y, self.conv2.weight, padding=1))
        return F.relu(y + x)


class ResNet18Stem(nn.Module):
    output_stride = 4
    output_channels = 64

    def __init__(self):
        super().__init__()
        self.add_module("0", nn.Conv2d(3, 64, 7, stride=2, padding=3,
                                       bias=False))
        self.add_module("1", MaskedBatchNorm(64))
        self.add_module("4", nn.Sequential(BasicBlock(64), BasicBlock(64)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H/4, W/4, 48] s2d(4) or [B, H, W, 3] RGB, in the compute
        dtype. Returns [B, H/4, W/4, 64]."""
        conv, bn, layer1 = (getattr(self, k) for k in ("0", "1", "4"))
        if x.shape[-1] == 48 or (x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0):
            ys = stem_conv_s2d(x, conv.weight)  # [B, U, V, 4*64]
            scale, shift = bn(ys, return_coefficients=True)
            x = bn_relu_pool_s2d(ys, scale, shift)
        else:
            y = F.relu(bn(nhwc_conv2d(x, conv.weight, stride=2, padding=3)))
            x = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1)
            x = x.permute(0, 2, 3, 1).contiguous()
        return layer1(x)
