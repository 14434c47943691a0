"""ResNet backbones, NHWC, truncatable after any stage.

Counterpart of ``cova_tpu/models/resnet.py`` with its registry
(``make_backbone``): ``resnet18_stem`` (the reference architecture: conv1
7x7/2 -> bn1 -> relu -> maxpool 3x3/2 -> layer1, output stride 4, 64
channels), ``resnet18``, ``resnet34_stem``, ``resnet50_stem`` and
``resnet50``. Child names are torchvision's in the reference's truncation
``nn.Sequential(resnet.children()[:-k])``: ``0`` conv1, ``1`` bn1, ``4`` ..
``7`` layer1 .. layer4 (the ReLU and the pool at 2 and 3 have no
parameters), blocks ``conv1/bn1/conv2/bn2[/conv3/bn3]`` and
``downsample.{0,1}``, so reference and torchvision state_dicts load
unchanged.

For an s2d(4) input (and RGB whose sides divide by 4) the stem runs the
conv in s2d form (``ops.conv_stem.stem_conv_s2d``), folds the four s2d(2)
phase groups into the BN statistics, and applies normalize + ReLU + pool in
one kernel (``ops.bn_pool.bn_relu_pool_s2d``). Other RGB sizes take the
plain ops. In training the stem's BN coefficients carry gradient (they
depend on ys through the batch statistics) and ``bn_relu_pool_s2d`` runs its
backward kernel.

Every stride-1 3x3 conv of a ``BasicBlock`` goes through
``ops.conv3x3.conv3x3_auto`` (``F.conv2d`` by default, the hand-written
kernel with ``COVA_CUDA_CONV=1``); strided and 1x1 convs, and the
``Bottleneck``'s, stay ``F.conv2d``, as they are ``nn.Conv`` in the JAX
package. ``COVA_REMAT=1`` recomputes each block's activations in the
backward (``torch.utils.checkpoint``); the state_dict does not change. The
JAX package's ``COVA_PACKED_W`` is a lane layout of the same values for the
TPU and has no counterpart here.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import BACKBONE_NAMES, BACKBONES, SWIN_BACKBONES
from ..ops.bn_act import bn_act
from ..ops.bn_pool import bn_relu_pool_s2d
from ..ops.conv3x3 import conv3x3_auto
from ..ops.conv_stem import nhwc_conv2d, stem_conv_s2d
from . import swin
from .layers import MaskedBatchNorm, frozen_running_stats

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


def use_remat() -> bool:
    """Recompute each backbone block's activations in the backward, keeping
    only block inputs between forward and backward: about one more block
    forward of work for the blocks' activation memory. Off by default;
    ``COVA_REMAT=1`` turns it on for deep backbones and large screenshots.
    Module names and state_dict keys are the same in both modes."""
    return os.environ.get("COVA_REMAT", "0") == "1"


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def _downsample(inplanes: int, planes: int, stride: int):
    if stride == 1 and inplanes == planes:
        return None
    return nn.Sequential(
        nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
        MaskedBatchNorm(planes),
    )


def _residual(block, x: torch.Tensor):
    """The block's residual before its BN: (x, None), or the downsample
    conv's output and the downsample's BN."""
    if block.downsample is None:
        return x, None
    conv, bn = block.downsample[0], block.downsample[1]
    return nhwc_conv2d(x, conv.weight, stride=block.stride), bn


def _bn_relu(bn: MaskedBatchNorm, y: torch.Tensor, r=None,
             res_bn=None) -> torch.Tensor:
    """``relu(bn(y) + res_bn?(r)?)``. In training mode, whose BN takes
    batch statistics, the modules run one by one; in eval mode each BN is
    a fixed affine, and ``bn_act`` does the whole in one pass (K9 where no
    gradient is needed)."""
    if bn.training or (res_bn is not None and res_bn.training):
        y = bn(y)
        if r is not None:
            y = y + (r if res_bn is None else res_bn(r))
        return F.relu(y)
    scale, shift = bn(y, return_coefficients=True)
    rs, rh = (None, None) if res_bn is None else res_bn(
        r, return_coefficients=True)
    return bn_act(y, scale, shift, relu=True, res=r, res_scale=rs,
                  res_shift=rh)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock, NHWC, with its attribute names."""

    expansion = 1

    def __init__(self, inplanes: int = 64, planes: int = 64, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm(planes)
        self.downsample = _downsample(inplanes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            y = conv3x3_auto(x, _hwio(self.conv1))
        else:
            y = nhwc_conv2d(x, self.conv1.weight, stride=self.stride,
                            padding=1)
        y = _bn_relu(self.bn1, y)
        y = conv3x3_auto(y, _hwio(self.conv2))
        return _bn_relu(self.bn2, y, *_residual(self, x))


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (the stride on the 3x3 conv), NHWC."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = MaskedBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = MaskedBatchNorm(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _bn_relu(self.bn1, nhwc_conv2d(x, self.conv1.weight))
        y = nhwc_conv2d(y, self.conv2.weight, stride=self.stride, padding=1)
        y = _bn_relu(self.bn2, y)
        y = nhwc_conv2d(y, self.conv3.weight)
        return _bn_relu(self.bn3, y, *_residual(self, x))


def _remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` with its activations recomputed in the backward. The
    recompute runs the block's forward a second time, which must not update
    the BatchNorm running statistics again."""
    seen = []

    def run(t):
        if not seen:
            seen.append(True)
            return block(t)
        with frozen_running_stats():
            return block(t)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class ResNetBackbone(nn.Module):
    """ResNet feature extractor keeping the first ``n_stages`` stages:
    1 is the reference's truncated stem (stride 4), 4 the full backbone
    (stride 32). ``x``: [B, H/4, W/4, 48] s2d(4) or [B, H, W, 3] RGB, in the
    compute dtype; returns [B, H/stride, W/stride, output_channels]."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block_cls=BasicBlock, n_stages: int = 1):
        super().__init__()
        self.n_stages = n_stages
        self.output_stride = 4 * 2 ** (n_stages - 1)
        self.output_channels = 64 * 2 ** (n_stages - 1) * block_cls.expansion
        self.add_module("0", nn.Conv2d(3, 64, 7, stride=2, padding=3,
                                       bias=False))
        self.add_module("1", MaskedBatchNorm(64))
        inplanes = 64
        for stage in range(n_stages):
            planes = 64 * 2**stage
            blocks = []
            for i in range(stage_sizes[stage]):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block_cls(inplanes, planes, stride))
                inplanes = planes * block_cls.expansion
            self.add_module(str(4 + stage), nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = getattr(self, "0"), getattr(self, "1")
        if x.shape[-1] == 48 or (x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0):
            ys = stem_conv_s2d(x, conv.weight)  # [B, U, V, 4*64]
            scale, shift = bn(ys, return_coefficients=True)
            x = bn_relu_pool_s2d(ys, scale, shift)
        else:
            y = F.relu(bn(nhwc_conv2d(x, conv.weight, stride=2, padding=3)))
            x = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1)
            x = x.permute(0, 2, 3, 1).contiguous()
        remat = use_remat() and torch.is_grad_enabled()
        for stage in range(self.n_stages):
            for block in getattr(self, str(4 + stage)):
                x = _remat(block, x) if remat else block(x)
        return x


def make_backbone(name: str) -> nn.Module:
    """Backbone registry: the ResNets of ``config.BACKBONES``, and the
    Swin-T trunk of ``models/swin.py`` (``config.SWIN_BACKBONES``)."""
    if name in SWIN_BACKBONES:
        return swin.SwinStage1Backbone()
    if name not in BACKBONES:
        raise ValueError(
            f"unknown backbone {name!r}; options: {list(BACKBONE_NAMES)}"
        )
    stage_sizes, n_stages, bottleneck = BACKBONES[name]
    block_cls = Bottleneck if bottleneck else BasicBlock
    return ResNetBackbone(stage_sizes, block_cls, n_stages)
