"""Train, eval and inference steps: loss, optimizer, metrics.

Counterpart of ``cova_tpu/train/steps.py``:

  * loss = cross-entropy summed over the valid boxes (f32);
  * optimizer = ``torch.optim.Adam(lr, weight_decay=wd)``: the decay is
    added to the gradient before the moments, which is the JAX package's
    optax chain (``add_decayed_weights``, ``scale_by_adam``, ``scale(-lr)``);
  * train accuracy counts argmax-correct over all valid boxes, BG included;
  * the eval metric is the reference's retrieval top-k.

The train step returns its metrics as device tensors, so the trainer
fetches them once per epoch. ``forward_step`` and ``eval_step`` run under
``torch.inference_mode()``; the train step does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.batching import Batch


def _to_device(a, device) -> torch.Tensor:
    """A host array on ``device``: pinned and non-blocking to a GPU. A
    tensor (a prefetched batch's) is taken as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def batch_to_device(batch: Batch, device) -> dict:
    """The model's keyword inputs for a ``Batch`` (host arrays, or tensors
    from ``data.device_prefetch``), on ``device``."""
    return dict(
        images_u8=_to_device(batch.images, device),
        boxes=_to_device(batch.boxes, device),
        box_mask=_to_device(batch.box_mask, device),
        context_indices=_to_device(batch.context_indices, device),
        additional_feats=(
            _to_device(batch.additional_feats, device)
            if batch.additional_feats.shape[-1] > 0 else None
        ),
    )


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer and the
    number of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(params, learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch ``Adam(lr, weight_decay=wd)``: grad += wd * param, then the
    Adam moments (0.9, 0.999, eps 1e-8), then the constant learning rate."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def create_train_state(model, cfg) -> TrainState:
    return TrainState(
        model=model,
        optimizer=make_optimizer(model.parameters(), cfg.learning_rate,
                                 cfg.weight_decay),
    )


def masked_ce_sum(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy over valid boxes (f32)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return (nll * mask.float()).sum()


def train_step(state: TrainState, batch: Batch,
               generator: Optional[torch.Generator] = None) -> dict:
    """One forward/backward/update in training mode (batch statistics, BN
    running-stat updates, dropout from ``generator``). Returns
    ``loss_sum``, ``n_correct`` and ``n_boxes`` as 0-d device tensors."""
    model = state.model
    model.train()
    inputs = batch_to_device(batch, state.device)
    labels = _to_device(batch.labels, state.device)
    mask = inputs["box_mask"]
    out = model(**inputs, generator=generator)
    loss = masked_ce_sum(out.logits, labels, mask)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        maskf = mask.float()
        preds = out.logits.argmax(-1)
        return {
            "loss_sum": loss.detach(),
            "n_correct": ((preds == labels).float() * maskf).sum(),
            "n_boxes": maskf.sum(),
        }


@torch.inference_mode()
def eval_step(model, batch: Batch, n_classes: int = 4, k: int = 1) -> dict:
    """Inference + retrieval metric; BN on running stats, dropout off."""
    model.eval()
    device = next(model.parameters()).device
    inputs = batch_to_device(batch, device)
    out = model(**inputs)
    labels = _to_device(batch.labels, device)
    correct, present = retrieval_metric(out.logits, labels,
                                        inputs["box_mask"], n_classes, k=k)
    return {"correct": correct, "present": present, "logits": out.logits}


@torch.inference_mode()
def forward_step(model, batch: Batch):
    """Plain inference returning logits + attention weights (BN on running
    stats, dropout off)."""
    return model(**batch_to_device(batch, next(model.parameters()).device))


def retrieval_metric(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    n_classes: int,
    k: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference eval metric, vectorized over pages.

    For each page and class c in 1..n_classes-1: correct iff the index of
    the (first) ground-truth class-c box is among the top-``k`` valid boxes
    ranked by the class-c logit. Returns (correct [B, n_classes-1] bool,
    present [B, n_classes-1] bool).

    Tie rule, as in the JAX package (``jax.lax.top_k``): among boxes with
    equal logits the LOWEST index ranks first; a stable descending sort
    gives that order. (The reference's ascending argsort keeps the highest
    index: the documented, measure-zero divergence.)
    """
    neg = torch.tensor(float("-inf"), device=logits.device)
    masked = torch.where(mask[..., None], logits.float(), neg)
    corrects, presents = [], []
    for c in range(1, n_classes):
        order = torch.sort(masked[..., c], dim=1, descending=True,
                           stable=True).indices
        topk_idx = order[:, :k]
        is_c = (labels == c) & mask
        present = is_c.any(dim=1)
        true_idx = is_c.int().argmax(dim=1)  # first class-c box
        hit = (topk_idx == true_idx[:, None]).any(dim=1)
        corrects.append(hit & present)
        presents.append(present)
    return torch.stack(corrects, 1), torch.stack(presents, 1)
