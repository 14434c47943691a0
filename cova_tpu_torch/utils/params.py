"""Parameter count (reference ``count_parameters``; counterpart of
``cova_tpu/utils/params.py``)."""

from __future__ import annotations

from torch import nn


def count_parameters(model: nn.Module) -> int:
    """Trainable parameters of a model (BN running statistics are buffers,
    not parameters). The flagship CoVA has 1,616,485, as the JAX package
    counts its params tree."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
