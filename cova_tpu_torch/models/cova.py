"""The CoVA model: representation network + GAT context + FC decoder.

Counterpart of ``cova_tpu/models/cova.py`` over padded batches:

  * a backbone from ``models.resnet.make_backbone`` (by default the
    truncated ResNet-18: stride 4, 64 channels; or the Swin-T trunk of
    ``models/swin.py``: stride 4, 96 channels) -> RoIPool(3x3) -> the
    visual feature per box (576-dim by default), flattened channel-major
    as the reference does;
  * bbox positional feature [x, y, w, h, aspect] -> Linear -> masked BN ->
    ReLU;
  * optional additional features through a masked BN;
  * one GAT layer over the preorder K-neighbourhood;
  * decoder Dropout -> Linear -> BN -> ReLU -> Dropout -> Linear.

In training mode the dropout masks come from a ``torch.Generator`` passed
to ``forward`` (the trainer keys one by (seed, epoch)), never from torch's
global RNG, so a resumed run draws the masks the uninterrupted run would
have. ``build_model`` initialises the weights from a generator seeded with
``cfg.seed``, with the JAX package's distributions: U(+-1/sqrt(fan_in)) for
Linear weights and biases (``cova_tpu/models/layers.py:24-29``) and
``he_normal`` for convs (``cova_tpu/models/resnet.py:31``).

Module and parameter names are the reference's torch namespace
(``convnet.{0,1,4..7}``, ``bbox_feat_encoder.{0,1}``, ``bn_additional_feat``,
``gat.{W_i,W_j,attention_layer}``, ``decoder.{1,2,5}``), so a reference
checkpoint, or one exported by ``cova export``, strict-loads with no
permutation.

Tensor parallelism (``tp_group``, set by ``parallel.mesh.parallelize``):
the GAT's projections and ``decoder.1`` hold this rank's rows and gather
their outputs over the model group; the rest of the model is replicated.

Numerics follow the JAX package: parameters stay f32 and are cast to the
compute dtype at use, BN math runs in f32 and is then cast, the GAT's
softmax and neighbour sum accumulate in f32, and logits and attention come
back in f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_pool import roi_pool
from ..parallel.collectives import copy_to_group, gather_last
from .gat import GraphAttention
from .layers import MaskedBatchNorm
from .resnet import he_normal_, make_backbone


class CoVAOutput(NamedTuple):
    logits: torch.Tensor  # [B, P, n_classes] float32
    attn_wts: Optional[torch.Tensor]  # [B, P, K] float32 or None


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator``: keep each
    element with probability 1 - p and scale it by 1 / (1 - p), as
    ``flax.linen.Dropout``."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("training with dropout needs an explicit "
                         "torch.Generator (forward(..., generator=...))")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class CoVA(nn.Module):
    def __init__(
        self,
        n_classes: int = 4,
        use_context: bool = True,
        hidden_dim: int = 384,
        bbox_hidden_dim: int = 32,
        n_additional_feat: int = 0,
        drop_prob: float = 0.2,
        roi_output_size: int = 3,
        backbone: str = "resnet18_stem",
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.use_context = use_context
        self.bbox_hidden_dim = bbox_hidden_dim
        self.n_additional_feat = n_additional_feat
        self.roi_output_size = roi_output_size
        self.compute_dtype = compute_dtype
        self.tp_group = None
        self.convnet = make_backbone(backbone)
        n_visual = self.convnet.output_channels * roi_output_size**2
        if bbox_hidden_dim > 0:
            self.bbox_feat_encoder = nn.Sequential(
                nn.Linear(5, bbox_hidden_dim),
                MaskedBatchNorm(bbox_hidden_dim),
                nn.ReLU(),
            )
        if n_additional_feat > 0:
            self.bn_additional_feat = MaskedBatchNorm(n_additional_feat)
        n_feat = n_visual + max(bbox_hidden_dim, 0) + n_additional_feat
        if use_context:
            self.gat = GraphAttention(n_feat, hidden_dim)
        n_total = n_feat + (hidden_dim if use_context else 0)
        self.decoder = nn.Sequential(
            nn.Dropout(drop_prob),
            nn.Linear(n_total, n_total),
            MaskedBatchNorm(n_total),
            nn.ReLU(),
            nn.Dropout(drop_prob),
            nn.Linear(n_total, n_classes),
        )

    def visual_features(self, images_u8, boxes, box_mask) -> torch.Tensor:
        """images_u8: [B, H, W, 3] uint8 or its host-side s2d(4) form
        [B, H/4, W/4, 48]; boxes: [B, P, 4]. -> [B, P, C*r*r]."""
        if images_u8.shape[-1] not in (3, 48):
            raise ValueError(
                "expected RGB [B,H,W,3] or s2d(4) [B,H/4,W/4,48] input, got "
                f"channels={images_u8.shape[-1]}"
            )
        x = images_u8.to(self.compute_dtype) / 255.0
        fm = self.convnet(x)  # [B, H/stride, W/stride, C]
        img_h = images_u8.shape[1] * (4 if images_u8.shape[-1] == 48 else 1)
        # The exact ratio, as the reference measures it (conv_H / img_H).
        spatial_scale = fm.shape[1] / img_h
        r = self.roi_output_size
        pooled = roi_pool(fm, boxes.float(), box_mask, spatial_scale, r, r)
        b, p = pooled.shape[:2]
        # Channel-major flatten ([C, r, r]), the reference's order.
        return pooled.permute(0, 1, 4, 2, 3).reshape(b, p, -1)

    def bbox_features(self, boxes, box_mask) -> torch.Tensor:
        """[x, y, w, h, aspect] -> Linear -> masked BN -> ReLU. Padded rows
        are zeroed first (w = h = 0 would give NaN aspect ratios)."""
        b, p = boxes.shape[:2]
        if self.bbox_hidden_dim <= 0:
            return boxes.new_zeros((b, p, 0), dtype=self.compute_dtype)
        x1, y1, x2, y2 = boxes.float().unbind(-1)
        w = x2 - x1
        h = y2 - y1
        pos = h > 0
        aspect = torch.where(pos, w / torch.where(pos, h, 1.0), 0.0)
        feats = torch.stack([x1, y1, w, h, aspect], dim=-1)
        feats = torch.where(box_mask[..., None], feats, 0.0)
        lin, bn = self.bbox_feat_encoder[0], self.bbox_feat_encoder[1]
        z = bn(_linear(lin, feats.to(self.compute_dtype)), box_mask)
        return F.relu(z)

    def forward(
        self,
        images_u8: torch.Tensor,  # [B, H/4, W/4, 48] or [B, H, W, 3] uint8
        boxes: torch.Tensor,  # [B, P, 4] float32 x1y1x2y2
        box_mask: torch.Tensor,  # [B, P] bool
        context_indices: torch.Tensor,  # [B, P, K] int32, -1 = pad
        additional_feats: Optional[torch.Tensor] = None,  # [B, P, F]
        generator: Optional[torch.Generator] = None,  # dropout, training
    ) -> CoVAOutput:
        dt = self.compute_dtype
        parts = [
            self.visual_features(images_u8, boxes, box_mask),
            self.bbox_features(boxes, box_mask),
        ]
        if self.n_additional_feat > 0:
            parts.append(
                self.bn_additional_feat(additional_feats.to(dt), box_mask)
            )
        own = torch.cat(parts, dim=-1)  # [B, P, n_feat]

        attn = None
        if self.use_context:
            ctx_repr, attn = self.gat(own, context_indices)
            combined = torch.cat([own, ctx_repr], dim=-1)
        else:
            combined = own

        # Dropout hits all rows as in the reference; padded rows are masked
        # downstream. d[0] and d[4] are the nn.Dropout slots of the
        # reference's Sequential: they hold p, the masks come from here.
        d = self.decoder

        def drop(t, slot):
            if not self.training:
                return t
            return _dropout(t, slot.p, generator)

        y = copy_to_group(drop(combined, d[0]), self.tp_group)
        y = gather_last(_linear(d[1], y), self.tp_group)
        y = d[2](y, box_mask)
        y = drop(F.relu(y), d[4])
        logits = _linear(d[5], y)
        return CoVAOutput(
            logits=logits.float(),
            attn_wts=None if attn is None else attn.float(),
        )


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every conv and Linear from ``generator`` with the JAX
    package's distributions: convs ``he_normal`` (fan_in, truncated
    normal), Linear weights and biases U(+-1/sqrt(fan_in)). BatchNorm keeps
    its constant init (weight 1, bias 0), as there. A trunk that the JAX
    package lacks (``swin_t_stage1``) takes its own published
    initialisation (its ``init_weights``)."""
    trunk_init = getattr(model.convnet, "init_weights", None)
    if trunk_init is not None:
        trunk_init(generator)
    skip = set(model.convnet.modules()) if trunk_init is not None else ()
    for mod in model.modules():
        if mod in skip:
            continue
        if isinstance(mod, nn.Conv2d):
            he_normal_(mod.weight, generator)
        elif isinstance(mod, nn.Linear):
            bound = 1.0 / mod.in_features**0.5
            for prm in (mod.weight, mod.bias):
                if prm is not None:
                    prm.uniform_(-bound, bound, generator=generator)


def build_model(cfg, device="cuda") -> CoVA:
    """The model of a ``Config``, in eval mode, on ``device``, with weights
    drawn on the CPU from a generator seeded with ``cfg.seed`` (the same
    weights on every device; torch's global RNG is left as it was)."""
    with torch.random.fork_rng(devices=[]):  # the modules' default init
        model = CoVA(
            n_classes=cfg.n_classes,
            use_context=cfg.use_context,
            hidden_dim=cfg.gat_hidden_dim,
            bbox_hidden_dim=cfg.bbox_hidden_dim,
            n_additional_feat=(
                cfg.n_additional_feat if cfg.use_additional_feat else 0
            ),
            drop_prob=cfg.drop_prob,
            roi_output_size=cfg.roi,
            backbone=cfg.backbone,
            compute_dtype=getattr(torch, cfg.compute_dtype),
        )
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device).eval()
