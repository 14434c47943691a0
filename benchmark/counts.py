"""The benchmark's own arithmetic of work: the model's operations and the
bytes each hand-written kernel has to move, from a cell's shapes.

Peaks are NVIDIA's H100 SXM data sheet: 989 TFLOP/s dense bf16 and
3.35 TB/s of HBM3. FLOPs count a multiply-add as two, over the published
layers, for the forward that serving runs: the trunk's, from its file
(``reference/trunks/<backbone>.py``; the ResNet stems count conv1 as the
7x7/2 conv on the screenshot, not the program's space-to-depth form), and
per valid box the bbox encoder, the attention's projections, scores and
neighbour sum, and the decoder. The trunk file also gives the feature
map's channels and stride, and the bytes of the kernels that only that
trunk runs (K9's).

A kernel's bytes count each input byte read once and each output byte
written once. The RoI pool reads the feature-map pixels that some bin of
some valid box covers (the union, worked out here from the boxes with the
bin rule), the boxes and mask, and writes its output. The stem pool reads
the conv's s2d(2) output [B, H/4, W/4, 4 * 64] and the affine, and writes
[B, H/4, W/4, 64].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .reference.cova import trunk

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
STEM_CHANNELS = 64


def trunk_flops(cfg: dict) -> float:
    """A page's trunk forward FLOPs at ``cfg["img_height"]``."""
    return float(trunk(cfg).flops(cfg))


def trunk_channels(cfg: dict) -> int:
    return trunk(cfg).CHANNELS


def box_flops(cfg: dict) -> float:
    """The head's forward FLOPs for one valid box."""
    nf = trunk_channels(cfg) * cfg["roi"] ** 2 + cfg["bbox_hidden_dim"]
    hd, k2 = cfg["hidden_dim"], 2 * cfg["context_size"]
    nt = nf + hd
    return (2.0 * 5 * cfg["bbox_hidden_dim"] + 2 * 2.0 * nf * hd
            + 2 * 2.0 * hd + 2.0 * k2 * hd + 2.0 * nt * nt
            + 2.0 * nt * cfg["n_classes"])


def step_flops(cfg: dict, valid_boxes: Sequence[int]) -> float:
    """FLOPs of one forward step over pages with ``valid_boxes`` boxes
    each."""
    return len(valid_boxes) * trunk_flops(cfg) + sum(
        valid_boxes) * box_flops(cfg)


def _quantize(v: np.ndarray, scale: float) -> np.ndarray:
    vs = v.astype(np.float32) * np.float32(scale)
    return np.trunc(vs + np.where(vs >= 0, 0.5, -0.5)).astype(np.int64)


def _bins(start, length, out, limit):
    i = np.arange(out)
    lo = (i * length[:, None]) // out + start[:, None]
    hi = ((i + 1) * length[:, None] + out - 1) // out + start[:, None]
    return np.clip(lo, 0, limit), np.clip(hi, 0, limit)


def covered_pixels(boxes_xyxy: np.ndarray, out: int, h: int, w: int,
                   scale: float) -> int:
    """Feature-map pixels that some non-empty bin of the boxes covers."""
    x1, y1, x2, y2 = (_quantize(boxes_xyxy[:, j], scale) for j in range(4))
    ylo, yhi = _bins(y1, np.maximum(y2 - y1 + 1, 1), out, h)
    xlo, xhi = _bins(x1, np.maximum(x2 - x1 + 1, 1), out, w)
    # Each bin a rectangle [y0, y1) x [x0, x1); their union by a 2-D
    # difference array.
    y0 = np.repeat(ylo, out, axis=1).ravel()
    y1 = np.repeat(yhi, out, axis=1).ravel()
    x0 = np.tile(xlo, (1, out)).ravel()
    x1 = np.tile(xhi, (1, out)).ravel()
    ok = (y1 > y0) & (x1 > x0)
    y0, y1, x0, x1 = y0[ok], y1[ok], x0[ok], x1[ok]
    diff = np.zeros((h + 1, w + 1), np.int64)
    np.add.at(diff, (y0, x0), 1)
    np.add.at(diff, (y0, x1), -1)
    np.add.at(diff, (y1, x0), -1)
    np.add.at(diff, (y1, x1), 1)
    cover = diff.cumsum(0).cumsum(1)[:h, :w] > 0
    return int(cover.sum())


def batch_shapes(pages: Sequence[dict], cfg: dict, padded_boxes: int) -> dict:
    """What the byte counts need of one batch of raw pages: its size, the
    padded box count, the feature map's sides and channels, the RoI bins a
    box, and the covered pixels and valid boxes of each page."""
    s = cfg["img_height"]
    h = s // trunk(cfg).STRIDE
    cov = []
    for pg in pages:
        xywh = np.asarray(pg["boxes_xywh"], np.float32)
        xyxy = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1)
        cov.append(covered_pixels(xyxy, cfg["roi"], h, h, h / s))
    return {"b": len(pages), "p": padded_boxes, "h": h, "w": h,
            "c": trunk_channels(cfg), "bins": cfg["roi"] ** 2,
            "covered": cov,
            "valid": [len(pg["labels"]) for pg in pages],
            "itemsize": 2 if cfg["compute_dtype"] == "bfloat16" else 4}


def roi_pool_bytes(sh: dict) -> float:
    """K1's bytes of a batch."""
    isz, c, r2 = sh["itemsize"], sh["c"], sh["bins"]
    fm = sum(sh["covered"]) * c * isz
    boxes = sh["b"] * sh["p"] * (16 + 1)
    pooled = sh["b"] * sh["p"] * r2 * c * isz
    return fm + boxes + pooled


def bn_pool_bytes(sh: dict) -> float:
    """K5's bytes of a batch."""
    isz, o = sh["itemsize"], STEM_CHANNELS
    px = sh["b"] * sh["h"] * sh["w"]
    return px * 4 * o * isz + 2 * o * 4 + px * o * isz


def bound_seconds(nbytes: float) -> float:
    return nbytes / PEAK_HBM_BYTES_PER_S

