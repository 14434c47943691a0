"""A Swin-T trunk cut after its first stage (``swin_t_stage1``), NHWC.

Swin-T (Liu et al. 2021, arXiv 2103.14030; ``microsoft/Swin-Transformer``
``configs/swin/swin_tiny_patch4_window7_224.yaml``) in the form of its
detection backbone (``SwinTransformer/Swin-Transformer-Object-Detection``,
``mmdet/models/backbones/swin_transformer.py``), which takes inputs whose
token map is not a multiple of the window, cut after stage 1 with its
output norm ``norm0``: stride 4, 96 channels, the place where CoVA cuts
ResNet-18 (after layer1). Published widths:

* the patch embedding, a 4x4/4 conv 3 -> 96 with a bias, then a LayerNorm.
  On the port's s2d(4) input [B, H/4, W/4, 48] (channel order (dy, dx,
  c)) it is one 48 -> 96 matmul a token, with the conv weight permuted to
  that order;
* two blocks, the first with windows (W-MSA), the second with windows
  shifted by 3 (SW-MSA): ``x + proj(attn(norm1(x)))``, then ``x +
  fc2(GELU(fc1(norm2(x))))``, fc1 96 -> 384; the attention: 3 heads of 32,
  window 7, a qkv bias, scale 32^-1/2, a relative-position bias from a
  169 x 3 table under a fixed 49 x 49 index (``ops.window_attn``; K10 on
  the card);
* ``norm0``, a LayerNorm over the 96 channels of the stage's output.

Drop-path is the identity in eval mode and is left out. Compute is in the
model's compute dtype (bf16 on the card: K10 and K11 take bf16 only); the
LayerNorms' statistics, the softmax and the matmuls' sums are f32. Each
residual add is taken by the LayerNorm that follows it (``ops.layernorm``;
K11 on the card), so a block hands its MLP output on unadded.
Parameters stay f32 and are cast at use, as in the other trunks. Module and
state_dict names are the published code's (under ``convnet.`` in CoVA).
K10 and K11 have no backward, so on the card the trunk serves; it trains on
the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SWIN_BACKBONES
from ..ops.layernorm import layernorm
from ..ops.window_attn import (relative_bias, relative_position_index,
                               window_attention)

DIM, PATCH = SWIN_BACKBONES["swin_t_stage1"]  # output channels and stride
DEPTH, HEADS, WINDOW, MLP_RATIO = 2, 3, 7, 4


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _norm(ln: nn.LayerNorm, x: torch.Tensor, res=None, sum_out=False):
    """``ln(x + res)`` in x's dtype (its statistics in f32), and with
    ``sum_out`` the sum too: K11 on the card."""
    return layernorm(x, ln.weight, ln.bias, ln.eps, res, sum_out=sum_out)


class PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Conv2d(3, DIM, PATCH, stride=PATCH)
        self.norm = nn.LayerNorm(DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H/4, W/4, 48] s2d(4) -> [B, H/4, W/4, 96]."""
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(DIM, -1)
        y = F.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype))
        return _norm(self.norm, y)


class WindowAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, HEADS))
        self.register_buffer("relative_position_index",
                             relative_position_index(WINDOW))
        self.qkv = nn.Linear(DIM, 3 * DIM)
        self.proj = nn.Linear(DIM, DIM)


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(DIM, MLP_RATIO * DIM)
        self.fc2 = nn.Linear(MLP_RATIO * DIM, DIM)


class SwinBlock(nn.Module):
    def __init__(self, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(DIM)
        self.attn = WindowAttention()
        self.norm2 = nn.LayerNorm(DIM)
        self.mlp = Mlp()

    def forward(self, x: torch.Tensor, branch=None):
        """The block on the stream ``x + branch`` (``branch``: the last
        block's MLP output, not yet added; None for the first block);
        returns the stream after the attention's add and the MLP's output,
        for the next LayerNorm to add."""
        attn = self.attn
        if branch is None:
            n = _norm(self.norm1, x)
        else:
            n, x = _norm(self.norm1, x, branch, sum_out=True)
        qkv = _linear(attn.qkv, n)
        bias = relative_bias(attn.relative_position_bias_table,
                             attn.relative_position_index)
        a = window_attention(qkv, bias, attn.qkv.bias.to(qkv.dtype),
                             self.shift)
        n, x = _norm(self.norm2, x, _linear(attn.proj, a), sum_out=True)
        h = F.gelu(_linear(self.mlp.fc1, n))
        return x, _linear(self.mlp.fc2, h)


class BasicLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(0 if i % 2 == 0 else WINDOW // 2) for i in range(DEPTH))


class SwinStage1Backbone(nn.Module):
    """``x``: [B, H/4, W/4, 48] s2d(4) or [B, H, W, 3] RGB (sides a
    multiple of 4), in the compute dtype; returns [B, H/4, W/4, 96]
    contiguous."""

    output_stride = PATCH
    output_channels = DIM

    def __init__(self):
        super().__init__()
        self.patch_embed = PatchEmbed()
        self.layers = nn.ModuleList([BasicLayer()])
        self.norm0 = nn.LayerNorm(DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 3:
            b, h, w, _ = x.shape
            if h % PATCH or w % PATCH:
                raise ValueError(f"SwinStage1Backbone: RGB sides must "
                                 f"divide by {PATCH}; got {h}x{w}")
            x = x.reshape(b, h // PATCH, PATCH, w // PATCH, PATCH, 3).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // PATCH, w // PATCH, -1)
        x, branch = self.patch_embed(x), None
        for block in self.layers[0].blocks:
            x, branch = block(x, branch)
        return _norm(self.norm0, x, branch).contiguous()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The published initialisation: Linear weights and the bias tables
        trunc-normal with std 0.02 (cut at +-2), Linear biases 0, LayerNorms
        1 and 0; the patch embedding keeps Conv2d's default, U(+-1 /
        sqrt(fan_in)) for its weight and bias."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, 0.0, 0.02, -2.0, 2.0,
                                      generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, WindowAttention):
                nn.init.trunc_normal_(mod.relative_position_bias_table, 0.0,
                                      0.02, -2.0, 2.0, generator=generator)
            elif isinstance(mod, nn.Conv2d):
                bound = mod.weight[0].numel() ** -0.5
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
