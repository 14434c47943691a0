"""The 7x7 stride-2 stem conv over a space-to-depth(4) input, and the plain
3x3/2 max-pool on its space-to-depth(2) output.

Counterpart of ``cova_tpu/ops/conv_stem.py``. The reformulation is exact:

    input  [B, H, W, 3]   -> s2d(4) -> [B, H/4, W/4, 48]
    conv7x7/2, pad 3  ==  conv3x3/1, pad 1, on the s2d(4) map with a sparse
                          [3, 3, 48, 4*O] kernel gathered from the 7x7 taps
    output [B, H/4, W/4, 4*O], channel order (ey, ex, o) = s2d(2) of the
           [B, H/2, W/2, O] conv output.

Tensors are NHWC at these functions' boundaries, as in the JAX package. The
3x3 conv goes through ``ops.conv3x3.conv3x3_auto``: ``F.conv2d`` on
channels-last views by default, the hand-written CUDA kernel with
``COVA_CUDA_CONV=1`` (the JAX package's gate is ``COVA_PALLAS_CONV``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_F = 4  # input space-to-depth factor
_G = 2  # output space-to-depth factor (= input stride)


@functools.lru_cache(maxsize=None)
def _tap_index(kh: int, kw: int, cin: int, pad: int) -> np.ndarray:
    """Gather map from the flat [kh*kw*cin + 1] taps (last = zero) to
    [3, 3, F*F*cin, G*G] positions.

    For output phase ey and tap ky, the input row offset inside the s2d(4)
    block grid is s = 2*ey + ky - pad: block shift floor(s/4) in {-1, 0, 1}
    (index du = shift + 1) and intra-block row s mod 4; the same for columns.
    """
    smin = 0 - pad
    smax = 2 * (_G - 1) + (kh - 1) - pad
    assert (smin // _F, smax // _F) == (-1, 1), (smin, smax)

    idx = np.full((3, 3, _F * _F * cin, _G * _G), kh * kw * cin, np.int64)
    for ey in range(_G):
        for ex in range(_G):
            for ky in range(kh):
                for kx in range(kw):
                    sy = 2 * ey + ky - pad
                    sx = 2 * ex + kx - pad
                    du, dy = sy // _F + 1, sy % _F
                    dv, dx = sx // _F + 1, sx % _F
                    for c in range(cin):
                        cin_flat = (dy * _F + dx) * cin + c
                        idx[du, dv, cin_flat, ey * _G + ex] = (
                            ky * kw + kx
                        ) * cin + c
    return idx


@functools.lru_cache(maxsize=None)
def _tap_index_on(kh: int, kw: int, cin: int, pad: int,
                  device: torch.device) -> torch.Tensor:
    """``_tap_index`` on ``device``, copied there once: a copy from the host
    in every forward would sync, and a CUDA graph cannot hold it (in the
    JAX package the index is a compile-time constant). Made as a normal
    tensor also when first asked for under ``torch.inference_mode()``: a
    later training forward saves it for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_tap_index(kh, kw, cin, pad)).to(device)


def s2d4_host(img: np.ndarray) -> np.ndarray:
    """Host-side space-to-depth(4): [H, W, C] -> [H/4, W/4, 16*C], channel
    order (dy, dx, c), the layout ``stem_conv_s2d`` consumes."""
    h, w, c = img.shape
    assert h % _F == 0 and w % _F == 0, (h, w)
    return np.ascontiguousarray(
        img.reshape(h // _F, _F, w // _F, _F, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(h // _F, w // _F, _F * _F * c)
    )


def s2d4(x: torch.Tensor) -> torch.Tensor:
    """On-device space-to-depth(4) of an NHWC batch."""
    b, h, w, c = x.shape
    return (
        x.reshape(b, h // _F, _F, w // _F, _F, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, h // _F, w // _F, _F * _F * c)
    )


def nhwc_conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` on an NHWC tensor with an OIHW weight, returning NHWC.
    The NCHW view of an NHWC tensor is channels-last, which cuDNN consumes
    and produces without a layout copy."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2), weight.to(x.dtype),
        stride=stride, padding=padding,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def stem_kernel_s2d(weight: torch.Tensor) -> torch.Tensor:
    """The [4*O, 48, 3, 3] (OIHW) kernel of ``stem_conv_s2d``, gathered from
    the 7x7 stem weight [O, 3, 7, 7] (torch's OIHW layout)."""
    o, cin, kh, kw = weight.shape
    idx = _tap_index_on(kh, kw, cin, kh // 2, weight.device)
    k7 = weight.permute(2, 3, 1, 0).reshape(kh * kw * cin, o)  # (ky, kx, c)
    k_flat = torch.cat([k7, k7.new_zeros(1, o)], 0)
    k4 = k_flat[idx]  # [3, 3, 48, 4, O]
    k4 = k4.reshape(3, 3, _F * _F * cin, _G * _G * o)  # HWIO, O = (ey ex o)
    return k4.permute(3, 2, 0, 1).contiguous()


def stem_conv_s2d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """7x7 stride-2 pad-3 conv with the output left in s2d(2) form.

    x: [B, H/4, W/4, 48] (``s2d4_host``) or [B, H, W, 3] with H, W % 4 == 0;
    weight: [O, 3, 7, 7]. Returns [B, H/4, W/4, 4*O] in x.dtype, channel
    order (ey, ex, o).
    """
    from .conv3x3 import conv3x3_auto  # imports nhwc_conv2d from here

    cin = weight.shape[1]
    xs = x if x.shape[-1] == _F * _F * cin else s2d4(x)
    return conv3x3_auto(xs, stem_kernel_s2d(weight).permute(2, 3, 1, 0))


def stem_pool_s2d(ys: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max-pool applied directly to the stem's s2d(2)
    output after BN and ReLU (values >= 0, so a zero pad cannot win).

    ys: [B, U, V, 4*O], channel order (ey, ex, o) -> [B, U, V, O]. Output
    row p pools input rows 2p-1, 2p, 2p+1, which live at s2d blocks
    (p-1, ey=1), (p, ey=0), (p, ey=1); the same for columns.
    """
    b, u, v, c4 = ys.shape
    o = c4 // (_G * _G)
    padded = F.pad(ys, (0, 0, 1, 0, 1, 0))  # top row and left column
    taps = [(-1, 1), (0, 0), (0, 1)]  # (block shift, phase)
    out = None
    for du, ey in taps:
        for dv, ex in taps:
            ch = (ey * _G + ex) * o
            tap = padded[
                :, du + 1 : du + 1 + u, dv + 1 : dv + 1 + v, ch : ch + o
            ]
            out = tap if out is None else torch.maximum(out, tap)
    return out
