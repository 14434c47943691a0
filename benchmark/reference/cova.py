"""Plain reference of the CoVA model for the benchmark: the eval-mode
forward in float32, with TF32 off.

It follows the published model (the CoVA paper, ECNLP-5 at ACL 2022, and
the reference repository kevalmorabia97/CoVA-Web-Object-Detection,
``models.py``): a trunk (the configuration's ``backbone``, in the file
``trunks/<backbone>.py``: the paper's is torchvision's ResNet-18 cut after
layer1), RoIPool 3x3 in ``torchvision.ops.roi_pool``'s semantics, a bbox
encoder ``[x, y, w, h, w/h] -> Linear -> BN -> ReLU``, one graph-attention
layer over the 2K DOM-preorder neighbours, and the decoder ``Dropout ->
Linear -> BN -> ReLU -> Dropout -> Linear`` (dropout is the identity in
eval mode; every BatchNorm reads its running statistics).

It works from raw pages (uint8 screenshots, xywh boxes, labels) and a dict
of weights and running statistics in the reference's state_dict names.
Padding, the box bucket and the context indices are worked out here again.

``quant="fp8"`` computes the same model with every conv and matmul operand
rounded to float8 e4m3 under one scale per tensor: the precision below
bfloat16, the benchmark's control.

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from types import ModuleType
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import trunks

NEG_INF = -9e15  # the reference repository's mask value in the attention
BN_EPS = 1e-5


def trunk(cfg: dict) -> ModuleType:
    """The configuration's trunk file (``trunks/<backbone>.py``)."""
    return trunks.load(cfg["backbone"])


def trunk_channels(cfg: dict) -> int:
    return trunk(cfg).CHANNELS


def n_feat(cfg: dict) -> int:
    return trunk_channels(cfg) * cfg["roi"] ** 2 + cfg["bbox_hidden_dim"]


def n_total(cfg: dict) -> int:
    return n_feat(cfg) + cfg["hidden_dim"]


def bn_shapes(prefix: str, c: int) -> Dict[str, tuple]:
    """The state_dict entries of a BatchNorm of ``c`` channels."""
    return {prefix + ".weight": ((c,), "bn_w"),
            prefix + ".bias": ((c,), "bn_b"),
            prefix + ".running_mean": ((c,), "bn_mean"),
            prefix + ".running_var": ((c,), "bn_var"),
            prefix + ".num_batches_tracked": ((), "bn_count")}


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """name -> (shape, kind[, extra]) of every tensor of the model's
    state_dict, in the reference's names: the trunk's ``convnet.*``
    entries, then the head's (kinds in ``weights.py``)."""
    out: "OrderedDict[str, tuple]" = OrderedDict(trunk(cfg).param_shapes(cfg))

    def linear(prefix, o, i, bias=True):
        out[prefix + ".weight"] = ((o, i), "linear_w", i)
        if bias:
            out[prefix + ".bias"] = ((o,), "linear_b", i)

    bbhd, hd = cfg["bbox_hidden_dim"], cfg["hidden_dim"]
    linear("bbox_feat_encoder.0", bbhd, 5)
    out.update(bn_shapes("bbox_feat_encoder.1", bbhd))
    linear("gat.W_i", hd, n_feat(cfg), bias=False)
    linear("gat.W_j", hd, n_feat(cfg), bias=False)
    linear("gat.attention_layer", 1, 2 * hd)
    linear("decoder.1", n_total(cfg), n_total(cfg))
    out.update(bn_shapes("decoder.2", n_total(cfg)))
    linear("decoder.5", cfg["n_classes"], n_total(cfg))
    return out


# ---- pages to padded tensors -------------------------------------------


def pad_boxes(cfg: dict) -> int:
    return -(-cfg["max_boxes"] // 8) * 8


def bucket(n_max: int, cfg: dict) -> int:
    """The padded box count of a batch whose largest page has ``n_max``
    boxes: the smallest bucket that holds it, else the padded maximum."""
    full = pad_boxes(cfg)
    for b in sorted(cfg["box_buckets"]):
        if b >= n_max:
            return min(b, full)
    return full


def context_indices(n: int, k: int) -> np.ndarray:
    """Per box, its up to k predecessors then up to k successors in DOM
    preorder, ascending, left-packed, -1 for none: [n, 2k]."""
    out = np.full((n, 2 * k), -1, np.int64)
    for i in range(n):
        nb = [j for j in range(i - k, i + k + 1) if j != i and 0 <= j < n]
        out[i, :len(nb)] = nb
    return out


def page_tensors(pages: Sequence[dict], cfg: dict, device) -> dict:
    """The model's inputs for a batch of raw pages (``image`` [H, W, 3]
    uint8, ``boxes_xywh`` [n, 4], ``labels`` [n]), padded to the batch's
    bucket."""
    p_pad = bucket(max(len(pg["labels"]) for pg in pages), cfg)
    k = cfg["context_size"]
    b = len(pages)
    boxes = np.zeros((b, p_pad, 4), np.float32)
    labels = np.zeros((b, p_pad), np.int64)
    mask = np.zeros((b, p_pad), bool)
    ctx = np.full((b, p_pad, 2 * k), -1, np.int64)
    for i, pg in enumerate(pages):
        n = len(pg["labels"])
        xywh = np.asarray(pg["boxes_xywh"], np.float32)
        boxes[i, :n, :2] = xywh[:, :2]
        boxes[i, :n, 2:] = xywh[:, :2] + xywh[:, 2:]
        labels[i, :n] = pg["labels"]
        mask[i, :n] = True
        ctx[i, :n] = context_indices(n, k)
    images = np.stack([pg["image"] for pg in pages])
    dev = torch.device(device)
    return {
        "images": torch.from_numpy(images).to(dev),
        "boxes": torch.from_numpy(boxes).to(dev),
        "labels": torch.from_numpy(labels).to(dev),
        "mask": torch.from_numpy(mask).to(dev),
        "ctx": torch.from_numpy(ctx).to(dev),
    }


# ---- float8 rounding (the control) --------------------------------------


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude onto the format's largest value; returned in x.dtype."""
    fmax = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, fmax / amax, torch.ones_like(amax))
    y = (x.float() * scale).clamp(-fmax, fmax).to(dtype).float() / scale
    return y.to(x.dtype)


def _op(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x
    if quant == "fp8":
        return _round_to(x, torch.float8_e4m3fn)
    raise ValueError(f"unknown quant {quant!r}")


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN convs and cuBLAS matmuls inside."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


# ---- layers ---------------------------------------------------------------


class _Model:
    """The model's eval-mode forward over a dict ``w`` of the weights and
    running statistics (floating tensors in f32). The trunk file's
    ``forward`` gets this object: its weights and helpers."""

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor],
                 quant: Optional[str]):
        self.cfg, self.w, self.quant = cfg, w, quant
        self.trunk = trunk(cfg)

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """A conv or matmul operand, rounded as the control rounds it."""
        return _op(x, self.quant)

    def conv(self, x, name, stride=1, padding=0):
        return F.conv2d(self.op(x), self.op(self.w[name]), stride=stride,
                        padding=padding)

    def linear(self, x, prefix, bias=True):
        b = self.w[prefix + ".bias"] if bias else None
        return F.linear(self.op(x), self.op(self.w[prefix + ".weight"]), b)

    def bn2d(self, x, prefix):
        w = self.w
        mean, var = w[prefix + ".running_mean"], w[prefix + ".running_var"]
        scale = w[prefix + ".weight"] / torch.sqrt(var + BN_EPS)
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + w[prefix + ".bias"][None, :, None, None])

    def bn_rows(self, x, prefix):
        """BatchNorm over the last dim of [B, P, F]."""
        w = self.w
        mean, var = w[prefix + ".running_mean"], w[prefix + ".running_var"]
        return ((x - mean) / torch.sqrt(var + BN_EPS) * w[prefix + ".weight"]
                + w[prefix + ".bias"])

    def __call__(self, t: dict) -> torch.Tensor:
        cfg = self.cfg
        x = t["images"].float().permute(0, 3, 1, 2) / 255.0
        fm = self.trunk.forward(self, x)  # [B, C, h, w]
        scale = fm.shape[2] / t["images"].shape[1]
        r = cfg["roi"]
        pooled = roi_pool(fm, t["boxes"], t["mask"], scale, r)  # [B,P,C,r,r]
        b, p = pooled.shape[:2]
        visual = pooled.reshape(b, p, -1)
        boxes, mask = t["boxes"], t["mask"]
        x1, y1, x2, y2 = boxes.unbind(-1)
        bw, bh = x2 - x1, y2 - y1
        aspect = torch.where(bh > 0, bw / torch.where(bh > 0, bh, 1.0), 0.0)
        feats = torch.stack([x1, y1, bw, bh, aspect], -1)
        feats = torch.where(mask[..., None], feats, 0.0)
        bbox = F.relu(self.bn_rows(self.linear(feats, "bbox_feat_encoder.0"),
                                   "bbox_feat_encoder.1"))
        own = torch.cat([visual, bbox], -1)
        ctx_repr = self.gat(own, t["ctx"])
        combined = torch.cat([own, ctx_repr], -1)
        y = F.relu(self.bn_rows(self.linear(combined, "decoder.1"),
                                "decoder.2"))
        return self.linear(y, "decoder.5")

    def gat(self, h, ctx):
        hd = self.cfg["hidden_dim"]
        wh_i = self.linear(h, "gat.W_i", bias=False)
        wh_j = self.linear(h, "gat.W_j", bias=False)
        a = self.w["gat.attention_layer.weight"][0]
        s_i = wh_i @ a[:hd] + self.w["gat.attention_layer.bias"][0]
        s_j_all = wh_j @ a[hd:]  # [B, P]
        b, p, k = ctx.shape
        safe = ctx.clamp(min=0)
        s_j = torch.gather(s_j_all, 1, safe.reshape(b, p * k)).reshape(b, p, k)
        e = F.leaky_relu(s_i[..., None] + s_j, negative_slope=0.2)
        e = torch.where(ctx >= 0, e, torch.full_like(e, NEG_INF))
        attn = torch.softmax(e, -1)
        attn = torch.where(ctx >= 0, attn, torch.zeros_like(attn))
        nbrs = torch.gather(
            wh_j, 1, safe.reshape(b, p * k, 1).expand(-1, -1, hd)
        ).reshape(b, p, k, hd)
        return torch.einsum("bpk,bpkh->bph", attn, nbrs)


# ---- RoIPool ---------------------------------------------------------------


def _quantize(v: torch.Tensor, scale: float) -> torch.Tensor:
    """C ``roundf(v * scale)``: half away from zero."""
    vs = v * scale
    return torch.trunc(vs + torch.where(vs >= 0, 0.5, -0.5)).long()


def _bins(start, length, out, limit):
    i = torch.arange(out, device=start.device)
    lo = (i * length[..., None]) // out + start[..., None]
    hi = ((i + 1) * length[..., None] + out - 1) // out + start[..., None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_bins(boxes, mask, scale, out, h, w):
    """Per box and bin: row bounds [lo, hi) and column bounds, each
    [B, P, out] int64, clipped to the map; a padding box's bins are
    empty."""
    x1, y1, x2, y2 = (_quantize(boxes[..., j], scale) for j in range(4))
    ylo, yhi = _bins(y1, (y2 - y1 + 1).clamp(min=1), out, h)
    xlo, xhi = _bins(x1, (x2 - x1 + 1).clamp(min=1), out, w)
    keep = mask[..., None]
    return (torch.where(keep, ylo, 0), torch.where(keep, yhi, 0),
            torch.where(keep, xlo, 0), torch.where(keep, xhi, 0))


def _levels(t: torch.Tensor, dim: int, span: int) -> List[torch.Tensor]:
    """A sparse table of ``t`` along ``dim``: level j holds the max over
    windows of 2**j, up to the longest window a query of ``span`` needs."""
    levels = [t]
    k = 1
    while 2 * k <= span:
        prev = levels[-1]
        n = prev.shape[dim]
        levels.append(torch.maximum(prev.narrow(dim, 0, n - k),
                                    prev.narrow(dim, k, n - k)))
        k *= 2
    return levels


def _range_max(levels, lo, hi, take) -> torch.Tensor:
    """max over [lo, hi) for each query (hi > lo) from ``levels``: two
    overlapping windows of the largest power of two that fits.
    ``take(level, positions, queries)`` reads a level."""
    q = hi - lo
    lev = torch.zeros_like(q)
    for j in range(1, len(levels)):
        lev += (q >= 2 ** j).long()
    out = None
    for j, lv in enumerate(levels):
        idx = (lev == j).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        v = torch.maximum(take(lv, lo[idx], idx),
                          take(lv, hi[idx] - 2 ** j, idx))
        if out is None:
            out = v.new_zeros((q.shape[0], *v.shape[1:]))
        out = out.index_copy(0, idx, v)
    return out


def roi_pool(fm: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
             scale: float, out: int) -> torch.Tensor:
    """RoI max-pool of ``fm`` [B, C, H, W] -> [B, P, C, out, out]; empty
    bins and padding boxes give 0."""
    b_, c, h, w = fm.shape
    p = boxes.shape[1]
    ylo, yhi, xlo, xhi = roi_bins(boxes, mask, scale, out, h, w)
    row_of = torch.arange(p * out, device=fm.device)
    row_of = row_of.reshape(p, out, 1).expand(p, out, out).reshape(-1)
    pages = []
    for b in range(b_):
        img = fm[b].permute(1, 2, 0)  # [H, W, C]
        # Rows first: each (box, bin row) pools its rows -> [P*out, W, C].
        lo, hi = ylo[b].reshape(-1), yhi[b].reshape(-1)
        rows_ok = hi > lo
        lo, hi = torch.where(rows_ok, lo, 0), torch.where(rows_ok, hi, 1)
        rows = _range_max(_levels(img, 0, int((hi - lo).max())), lo, hi,
                          lambda lv, pos, idx: lv[pos])
        # Then columns of each row-pooled row -> [P*out*out, C].
        lo = xlo[b][:, None, :].expand(p, out, out).reshape(-1)
        hi = xhi[b][:, None, :].expand(p, out, out).reshape(-1)
        ok = (hi > lo) & rows_ok[row_of]
        lo, hi = torch.where(ok, lo, 0), torch.where(ok, hi, 1)
        bins = _range_max(_levels(rows, 1, int((hi - lo).max())), lo, hi,
                          lambda lv, pos, idx: lv[row_of[idx], pos])
        bins = torch.where(ok[:, None], bins, 0.0)
        pages.append(bins.reshape(p, out, out, c).permute(0, 3, 1, 2))
    return torch.stack(pages, 0)


# ---- serving ---------------------------------------------------------------


def serve(weights: Dict[str, torch.Tensor], batches: Sequence[Sequence[dict]],
          cfg: dict, device, quant: Optional[str] = None) -> List[np.ndarray]:
    """Eval-mode logits [B, P, classes] of each batch of raw pages, as
    numpy float32."""
    w = {n: t.to(device=device, dtype=torch.float32)
         if t.is_floating_point() else t.to(device=device)
         for n, t in weights.items()}
    model = _Model(cfg, w, quant=quant)
    out = []
    with torch.no_grad(), float32_exact():
        for pages in batches:
            out.append(model(page_tensors(pages, cfg, device)).cpu().numpy())
    return out
