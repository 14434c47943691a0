"""Masked BatchNorm over padded rows.

Counterpart of ``cova_tpu/models/layers.py::MaskedBatchNorm``. The reference
normalizes over all real boxes of a batch; the padded layout therefore needs
a BatchNorm that (a) computes batch statistics over valid rows only, (b)
normalizes with the biased variance, and (c) updates the running stats with
the unbiased variance, exactly torch's ``BatchNorm1d`` split. Parameter and
buffer names are torch's (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``), so reference state_dicts load.

With a data group (``group``, set by ``parallel.mesh.parallelize``) the
statistics cover the global batch, as XLA's cross-replica reductions do for
the JAX package on a mesh: each rank's sums (s1, s2, count) are all-reduced
before the mean and variance are formed, and the running update and the
skip of an all-padding batch read the global values.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..parallel.collectives import all_reduce_sum

# True while a forward is being re-run to recompute activations (remat):
# the batch statistics are taken again, the running ones are left alone.
_stats_frozen = False


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, a training-mode ``MaskedBatchNorm`` normalizes with its batch
    statistics and does not update its running statistics."""
    global _stats_frozen
    before, _stats_frozen = _stats_frozen, True
    try:
        yield
    finally:
        _stats_frozen = before


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last dim of a padded [..., g * features] tensor,
    with statistics reduced over every leading dim.

    Group fold: an input with g = channels / features > 1 carries g channel
    groups of ``features`` each, group-major (the stem conv's s2d(2)
    output, channel order (ey, ex, o)); statistics fold over the groups,
    which equals BatchNorm over the unpacked layout. Momentum 0.1 and eps
    1e-5, as torch. ``group``: the data group whose ranks' statistics are
    summed (None: this rank's batch alone).
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.eps = eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer(
            "num_batches_tracked", torch.tensor(0, dtype=torch.int64)
        )

    def _batch_stats(self, xf: torch.Tensor, mask: Optional[torch.Tensor],
                     g: int):
        """(mean, biased var, count, valid-row count or None) of the batch;
        with a group, of the global batch: every rank's (s1, s2, count) are
        summed over the data group in one all-reduce, whose backward sums
        the gradients of s1 and s2 (and so K6's d(scale) and d(shift))."""
        f = self.features
        red = tuple(range(xf.ndim - 1))
        if mask is None:
            n = torch.tensor(float(xf.numel() // xf.shape[-1] * g),
                             device=xf.device)
            s1 = xf.sum(red)
            s2 = (xf * xf).sum(red)
        else:
            if g != 1:
                raise ValueError("a group fold needs an unmasked input")
            m = mask.to(torch.float32)[..., None]
            n = m.sum()
            s1 = (xf * m).sum(red)
            s2 = (xf * xf * m).sum(red)
        if g > 1:
            s1 = s1.reshape(g, f).sum(0)
            s2 = s2.reshape(g, f).sum(0)
        if self.group is not None:
            tot = all_reduce_sum(torch.cat([s1, s2, n.reshape(1)]),
                                 self.group)
            s1, s2, n = tot[:f], tot[f:2 * f], tot[2 * f]
        cnt = n if mask is None else n.clamp(min=1.0)
        mean = s1 / cnt
        var = s2 / cnt - mean * mean
        return mean, var.clamp(min=0.0), cnt, None if mask is None else n

    @torch.no_grad()
    def _update_running(self, mean, var, cnt, n_valid) -> None:
        # torch: the running update uses the unbiased variance. An
        # all-padding batch (no valid row on any rank) has no statistics
        # and skips the update.
        unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
        upd = self.momentum * (
            1.0 if n_valid is None else (n_valid > 0).float()
        )
        self.running_mean.mul_(1 - upd).add_(upd * mean)
        self.running_var.mul_(1 - upd).add_(upd * unbiased)
        self.num_batches_tracked.add_(1)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        return_coefficients: bool = False,
    ):
        """Normalize ``x`` (batch statistics in training mode, running
        statistics in eval mode) in f32 and return it in x.dtype; or, with
        ``return_coefficients``, return the effective [features] f32 affine
        (scale, shift) with ``y = x * scale + shift`` for a fused kernel."""
        f = self.features
        g = x.shape[-1] // f
        if x.shape[-1] != g * f:
            raise ValueError(f"expected a multiple of {f} channels, got "
                             f"{x.shape}")
        xf = None  # the f32 copy of x, made only where a pass reads it
        if self.training:
            xf = x.float()
            mean, var, cnt, n_valid = self._batch_stats(xf, mask, g)
            if not _stats_frozen:
                self._update_running(mean, var, cnt, n_valid)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        shift = self.bias.float() - mean * scale
        if return_coefficients:
            return scale, shift
        if g > 1:
            scale, shift = scale.repeat(g), shift.repeat(g)
        if xf is None:
            xf = x.float()
        return (xf * scale + shift).to(x.dtype)
