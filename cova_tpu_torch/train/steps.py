"""Train, eval and inference steps: loss, optimizer, metrics.

Counterpart of ``cova_tpu/train/steps.py``:

  * loss = cross-entropy summed over the valid boxes (f32);
  * optimizer = ``torch.optim.Adam(lr, weight_decay=wd)``: the decay is
    added to the gradient before the moments, which is the JAX package's
    optax chain (``add_decayed_weights``, ``scale_by_adam``, ``scale(-lr)``);
  * train accuracy counts argmax-correct over all valid boxes, BG included;
  * the eval metric is the reference's retrieval top-k.

On a mesh (``TrainState.mesh``) the step sums every gradient over the data
group after the backward, in one flat f32 bucket, and then takes the Adam
step: the loss is a CE sum over the global batch, so gradients are summed,
never averaged (``weight_decay`` makes their scale matter). A
tensor-sharded parameter's slice is summed over the data group only; the
replicated parameters' gradients are made bit-equal across the model group
(``reduce_gradients``).

The train step returns its metrics as device tensors, so the trainer
fetches them once per epoch. ``forward_step`` and ``eval_step`` run under
``torch.inference_mode()``; the train step does not.

On one CUDA device the three steps run through CUDA graphs, one per shape
and setting, as the JAX package's are jitted (``train/graphs.py``); the
keyword ``graphs=False`` runs them eagerly, and on the CPU and on a mesh
they always run eagerly. On CUDA, Adam is ``capturable``: its step counts
stay on the device and its bias correction is computed there in f32, so
the card's updates differ in their last bits from those of the host-side
path that the CPU runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.batching import Batch
from ..parallel.collectives import all_reduce_, broadcast_
from ..parallel.mesh import MODEL_SHARDED
from ..utils.tracing import span
from . import graphs as step_graphs


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
    """The model (parameters and BN statistics), its optimizer, the number
    of steps taken, the mesh the model is laid out on (None: one device)
    and its train steps' graphs (``graphs.state_graphs``; None until the
    first graphed step)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: Optional[object] = None
    graphs: Optional[step_graphs.StepGraphs] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(params, learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch ``Adam(lr, weight_decay=wd)``: grad += wd * param, then the
    Adam moments (0.9, 0.999, eps 1e-8), then the constant learning rate.
    ``capturable`` on CUDA, so that a CUDA graph can hold the step (torch
    refuses it for CPU parameters)."""
    params = list(params)
    capturable = bool(params) and params[0].device.type == "cuda"
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            capturable=capturable)


def create_train_state(model, cfg, mesh=None) -> TrainState:
    """The train state of ``model``, laid out on ``mesh`` first (see
    ``parallel.mesh.parallelize``) so that the optimizer holds this rank's
    parameters."""
    if mesh is not None:
        from ..parallel.mesh import parallelize

        parallelize(model, mesh)
    return TrainState(
        model=model,
        optimizer=make_optimizer(model.parameters(), cfg.learning_rate,
                                 cfg.weight_decay),
        mesh=mesh,
    )


@torch.no_grad()
def reduce_gradients(model, mesh) -> dict:
    """Sum every gradient over the data group in one flat f32 all-reduce
    (the bucket). With a model axis, the replicated parameters' part of the
    bucket is then broadcast from the first rank of the model group: each
    rank computed it alone, and atomics in the backward (cuDNN's weight
    gradients, scatter-adds) make those copies differ in their last bits,
    which would let the replicas drift apart. Returns the bytes of each
    collective."""
    named = [(n, p.grad) for n, p in model.named_parameters()
             if p.grad is not None]
    rep = [g for n, g in named if n not in MODEL_SHARDED]
    shard = [g for n, g in named if n in MODEL_SHARDED]
    grads = rep + shard
    out = {"allreduce_bytes": 0, "broadcast_bytes": 0}
    if mesh is None or not grads:
        return out
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    if mesh.data_group is not None:
        all_reduce_(flat, mesh.data_group)
        out["allreduce_bytes"] = flat.numel() * flat.element_size()
    if mesh.model_group is not None:
        n_rep = sum(g.numel() for g in rep)
        head = flat[:n_rep]
        broadcast_(head, mesh.model_root, mesh.model_group)
        out["broadcast_bytes"] = head.numel() * head.element_size()
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    return out


def masked_ce_sum(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy over valid boxes (f32)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return (nll * mask.float()).sum()


def forward_backward(state: TrainState, batch: Batch,
                     generator: Optional[torch.Generator] = None) -> dict:
    """The forward and backward of a train step in training mode (batch
    statistics, BN running-stat updates, dropout from ``generator``),
    leaving in each ``.grad`` the gradient of the global batch's loss (on a
    mesh, summed over the data group). Returns ``loss_sum``, ``n_correct``
    and ``n_boxes`` of this rank's rows as 0-d device tensors."""
    labels = _to_device(batch.labels, state.device)
    return _forward_backward(state, generator, labels,
                             **batch_to_device(batch, state.device))


def _forward_backward(state: TrainState, generator, labels,
                      **inputs) -> dict:
    model = state.model
    model.train()
    mask = inputs["box_mask"]
    out = model(**inputs, generator=generator)
    loss = masked_ce_sum(out.logits, labels, mask)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if state.mesh is not None:
        reduce_gradients(model, state.mesh)
    with torch.no_grad():
        maskf = mask.float()
        preds = out.logits.argmax(-1)
        return {
            "loss_sum": loss.detach(),
            "n_correct": ((preds == labels).float() * maskf).sum(),
            "n_boxes": maskf.sum(),
        }


def _train_body(state: TrainState, generator, **inputs) -> dict:
    """The device work of a train step: forward, backward, Adam."""
    metrics = _forward_backward(state, generator, **inputs)
    state.optimizer.step()
    return metrics


# The host range of every train step in a profiler trace, eager or replayed
# (a graph's replay runs no Adam on the host); scripts/read_torch_trace.py
# counts steps by it.
STEP_RANGE = "cova_tpu_torch.train_step"
# The host range of every serving step (``forward_step``).
FORWARD_RANGE = "cova_tpu_torch.forward_step"


def train_step(state: TrainState, batch: Batch,
               generator: Optional[torch.Generator] = None,
               graphs: bool = True) -> dict:
    """One forward/backward/update (``forward_backward``, then Adam).
    Returns ``loss_sum``, ``n_correct`` and ``n_boxes`` as 0-d device
    tensors (this rank's rows). ``graphs``: through the state's train
    graph of this batch's shape where ``graphs.enabled`` allows it."""
    with span(STEP_RANGE):
        state.model.train()
        inputs = batch_to_device(batch, state.device)
        inputs["labels"] = _to_device(batch.labels, state.device)
        body = functools.partial(_train_body, state, generator)
        if step_graphs.enabled(graphs, state.device, state.mesh):
            key = step_graphs.step_key("train", state.model, inputs,
                                       generator)
            metrics = step_graphs.state_graphs(state).run(
                key, body, inputs, () if generator is None else (generator,))
        else:
            metrics = body(**inputs)
    state.step += 1
    return metrics


@torch.inference_mode()
def eval_step(model, batch: Batch, n_classes: int = 4, k: int = 1,
              graphs: bool = True) -> dict:
    """Inference + retrieval metric; BN on running stats, dropout off.
    ``graphs``: through the model's eval graph of this batch's shape where
    ``graphs.enabled`` allows it (the caller passes False on a mesh)."""
    model.eval()
    device = next(model.parameters()).device
    inputs = batch_to_device(batch, device)
    inputs["labels"] = _to_device(batch.labels, device)
    body = functools.partial(_eval_body, model, n_classes, k)
    if step_graphs.enabled(graphs, device):
        key = step_graphs.step_key("eval", model, inputs, n_classes, k)
        return step_graphs.model_graphs(model).run(key, body, inputs)
    return body(**inputs)


def _eval_body(model, n_classes: int, k: int, labels, **inputs) -> dict:
    out = model(**inputs)
    correct, present = retrieval_metric(out.logits, labels,
                                        inputs["box_mask"], n_classes, k=k)
    return {"correct": correct, "present": present, "logits": out.logits}


@torch.inference_mode()
def forward_step(model, batch: Batch, graphs: bool = True):
    """Plain inference returning logits + attention weights (BN on running
    stats, dropout off). ``graphs``: through the model's forward graph of
    this batch's shape where ``graphs.enabled`` allows it (the caller
    passes False on a mesh)."""
    with span(FORWARD_RANGE):
        device = next(model.parameters()).device
        inputs = batch_to_device(batch, device)
        if step_graphs.enabled(graphs, device):
            key = step_graphs.step_key("forward", model, inputs)
            return step_graphs.model_graphs(model).run(key, model, inputs)
        return model(**inputs)


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
    neg = torch.full((), float("-inf"), device=logits.device)
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
