"""What the two ResNet stems share: torchvision's ResNet cut after layer1
(He et al. 2016, arXiv 1512.03385). conv1 7x7/2 (64 channels, no bias),
BN, ReLU, max-pool 3x3/2, then layer1's blocks at stride 4: BasicBlocks
(two 3x3 convs of 64) or Bottlenecks (1x1 to 64, 3x3, 1x1 to 256, the
first with a 1x1 conv and BN on its residual).

The port runs two hand-written kernels here: K5 (the stem's BN, ReLU and
max-pool; ``counts.bn_pool_bytes``) and K9 (each block's eval-mode BN
affine, residual add and ReLU; ``bn_act_bytes``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch.nn.functional as F

from ..cova import bn_shapes

STEM = 64
STRIDE = 4


def channels(kind: str) -> int:
    return 256 if kind == "bottleneck" else STEM


def param_shapes(kind: str, blocks: int) -> "OrderedDict[str, tuple]":
    out: "OrderedDict[str, tuple]" = OrderedDict()

    def conv(name, o, i, k):
        out[name] = ((o, i, k, k), "conv")

    conv("convnet.0.weight", STEM, 3, 7)
    out.update(bn_shapes("convnet.1", STEM))
    inplanes = STEM
    for b in range(blocks):
        p = f"convnet.4.{b}"
        if kind == "basic":
            conv(p + ".conv1.weight", 64, inplanes, 3)
            out.update(bn_shapes(p + ".bn1", 64))
            conv(p + ".conv2.weight", 64, 64, 3)
            out.update(bn_shapes(p + ".bn2", 64))
            inplanes = 64
        else:
            conv(p + ".conv1.weight", 64, inplanes, 1)
            out.update(bn_shapes(p + ".bn1", 64))
            conv(p + ".conv2.weight", 64, 64, 3)
            out.update(bn_shapes(p + ".bn2", 64))
            conv(p + ".conv3.weight", 256, 64, 1)
            out.update(bn_shapes(p + ".bn3", 256))
            if inplanes != 256:
                conv(p + ".downsample.0.weight", 256, inplanes, 1)
                out.update(bn_shapes(p + ".downsample.1", 256))
            inplanes = 256
    return out


def forward(m, x, kind: str, blocks: int):
    y = m.conv(x, "convnet.0.weight", stride=2, padding=3)
    y = F.relu(m.bn2d(y, "convnet.1"))
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    for b in range(blocks):
        p = f"convnet.4.{b}"
        if kind == "basic":
            z = F.relu(m.bn2d(m.conv(y, p + ".conv1.weight", padding=1),
                              p + ".bn1"))
            z = m.bn2d(m.conv(z, p + ".conv2.weight", padding=1), p + ".bn2")
            y = F.relu(z + y)
        else:
            z = F.relu(m.bn2d(m.conv(y, p + ".conv1.weight"), p + ".bn1"))
            z = F.relu(m.bn2d(m.conv(z, p + ".conv2.weight", padding=1),
                              p + ".bn2"))
            z = m.bn2d(m.conv(z, p + ".conv3.weight"), p + ".bn3")
            if p + ".downsample.0.weight" in m.w:
                res = m.bn2d(m.conv(y, p + ".downsample.0.weight"),
                             p + ".downsample.1")
            else:
                res = y
            y = F.relu(z + res)
    return y


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cout * cin * k * k


def flops(img_height: int, kind: str, blocks: int) -> float:
    h2, h4 = img_height // 2, img_height // 4
    f = _conv(h2, h2, 3, STEM, 7)
    cin = STEM
    for _ in range(blocks):
        if kind == "basic":
            f += 2 * _conv(h4, h4, 64, 64, 3)
        else:
            f += _conv(h4, h4, cin, 64, 1) + _conv(h4, h4, 64, 64, 3) \
                + _conv(h4, h4, 64, 256, 1)
            if cin != 256:
                f += _conv(h4, h4, cin, 256, 1)
            cin = 256
    return f


def bn_act_bytes(sh: dict, kind: str, blocks: int) -> float:
    """K9's bytes of a batch (``counts.batch_shapes``): each launch reads
    its map, and its residual where it has one, writes its output, and
    reads its f32 scale and shift (and the residual's pair where the
    downsample's BN is folded in). A BasicBlock: bn1 + ReLU (4 N64 bytes
    in bf16, N_c the elements of a [B, h, w, c] map), bn2 + residual +
    ReLU (6 N64). A Bottleneck: bn1 and bn2 + ReLU (4 N64 each), bn3 +
    residual + ReLU (6 N256)."""
    isz = sh["itemsize"]
    px = sh["b"] * sh["h"] * sh["w"]
    coef = 2 * 4  # scale and shift, f32, per channel
    total = 0
    if kind == "basic":
        for _ in range(blocks):
            total += 2 * px * 64 * isz + coef * 64
            total += 3 * px * 64 * isz + coef * 64
        return float(total)
    for b in range(blocks):
        total += 2 * (2 * px * 64 * isz + coef * 64)
        total += 3 * px * 256 * isz + coef * 256
        if b == 0:  # the downsample's BN, folded into the same launch
            total += coef * 256
    return float(total)
