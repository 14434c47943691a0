"""Graph-attention context layer over the DOM-preorder K-neighbourhood.

Counterpart of ``cova_tpu/models/gat.py`` with the reference's parameter
names (``W_i``, ``W_j``, ``attention_layer``): two bias-free projections, a
concat-MLP attention logit with LeakyReLU(0.2), -9e15 masking of empty
neighbour slots, softmax over K in f32, and an output that aggregates the
projected neighbours (no final nonlinearity, one head).

Projections run before any gather, and the logit
``a . [Wh_i ; Wh_j] + b`` splits into ``a1 . Wh_i + b`` and ``a2 . Wh_j``,
so only per-node scalars are gathered for the scores.

Tensor parallelism (``tp_group``, set by ``parallel.mesh.parallelize``):
``W_i`` and ``W_j`` then hold this rank's rows of the projections (the JAX
package shards their kernels' output axis on the mesh's model axis); each
rank projects its slice and the slices are gathered, so everything after
the projections runs replicated.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gat_attention import gather_scalar, neighbor_aggregate
from ..parallel.collectives import copy_to_group, gather_last

NEG_INF = -9e15  # the reference's mask value


class GraphAttention(nn.Module):
    def __init__(self, in_features: int, hidden_dim: int, alpha: float = 0.2):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.alpha = alpha
        self.W_i = nn.Linear(in_features, hidden_dim, bias=False)
        self.W_j = nn.Linear(in_features, hidden_dim, bias=False)
        self.attention_layer = nn.Linear(2 * hidden_dim, 1)
        self.tp_group = None

    def forward(
        self, h: torch.Tensor, ctx_idx: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h: [B, P, F] in the compute dtype; ctx_idx: [B, P, K] per-image
        indices, -1 = empty. Returns (context repr [B, P, H] and attention
        weights [B, P, K], both in h.dtype)."""
        dt = h.dtype
        g = self.tp_group
        h_tp = copy_to_group(h, g)
        wh_i = gather_last(F.linear(h_tp, self.W_i.weight.to(dt)), g)
        wh_j = gather_last(F.linear(h_tp, self.W_j.weight.to(dt)), g)
        a = self.attention_layer.weight[0].to(dt)
        s_i = wh_i @ a[: self.hidden_dim] + self.attention_layer.bias.to(dt)
        s_j = gather_scalar(wh_j @ a[self.hidden_dim :], ctx_idx)

        e = F.leaky_relu(s_i[..., None] + s_j, negative_slope=self.alpha)
        e = torch.where(ctx_idx >= 0, e.float(),
                        torch.full((), NEG_INF, device=e.device))
        attn = torch.softmax(e, dim=-1).to(dt)
        return neighbor_aggregate(wh_j, attn, ctx_idx), attn
