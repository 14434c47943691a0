"""Training loop: epochs, periodic eval, early stopping, best checkpoint.

Counterpart of ``cova_tpu/train/trainer.py`` (the reference's
``train_model`` / ``evaluate_model``):

  * the epoch line, the eval cadence (``epoch == 1 or epoch % interval == 0
    or epoch == n_epochs``), early stopping with patience on the mean
    non-BG val class accuracy, and restore-best-at-end match the reference;
  * train metrics stay on the device and are fetched once per epoch;
  * each epoch's dropout masks come from a ``torch.Generator`` keyed by
    (seed, epoch), and on a mesh by (seed, epoch, data rank), so
    ``--resume`` continues the exact stream of an uninterrupted run;
  * checkpoints carry the optimizer state (``utils/checkpoint.py``);
  * batches reach the device through ``data.device_prefetch``: the next
    batch's copy runs on a side stream while the current step computes.

On a mesh (``state.mesh``, see ``parallel/mesh.py``) every rank runs this
loop: each data rank feeds its stripe of the epoch (``make_pipelines(...,
host_shard)``), bucketed to the global batch's largest box count; the epoch
sums of loss, correct and box counts are summed over the data group; eval
pads each batch to a multiple of the data degree, each data rank runs its
rows, and the per-page flags are assembled on every rank.

Eval runs one batch per call. The JAX package's RSS watchdog, VMEM
fallback and eval chunking have no counterpart here.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.batching import Batch, bucket_batch, pad_batch
from ..data.device_prefetch import device_prefetch
from ..parallel.collectives import all_reduce_
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import MetricsLogger, print_and_log
from .steps import TrainState, eval_step, train_step


def dropout_generator(seed: int, epoch: int, device,
                      data_rank: int = 0) -> torch.Generator:
    """The generator of an epoch's dropout masks, keyed by (seed, epoch)
    and, on data ranks past the first, by the data rank (the ranks of one
    model row share a stream: their activations are replicated)."""
    entropy = [seed, epoch] + ([data_rank] if data_rank else [])
    key = int(np.random.SeedSequence(entropy).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(key)


def run_eval(
    model,
    pipeline,
    n_classes: int,
    class_names: Sequence[str],
    split_name: str = "VAL",
    log_file: Optional[str] = None,
    k: int = 1,
    box_buckets: Tuple[int, ...] = (),
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate one split. Returns (img_acc [n_imgs, n_classes] int32 with
    img_id in column 0, class_acc [n_classes] percentages), the reference
    ``evaluate_model`` contract. ``k`` is the retrieval depth.

    ``mesh``: the layout ``model`` runs on. Each batch is padded up to a
    multiple of the data degree (padded pages are masked), bucketed as a
    whole, and data rank d runs its block of rows; the flags are then
    assembled on every rank by an all-reduce of a zero-filled buffer over
    the data group (the ranks of one model row run the same rows)."""
    start = time.time()
    eval_bs = pipeline.batch_size
    dp = mesh.n_data if mesh is not None else 1
    d = mesh.data_index if mesh is not None else 0
    group = mesh.data_group if mesh is not None else None
    pad_bs = -(-eval_bs // dp) * dp
    per = pad_bs // dp
    rows = []
    device = next(model.parameters()).device

    def mine(batch: Batch) -> Batch:
        full = bucket_batch(pad_batch(batch, pad_bs)[0], box_buckets)
        if dp == 1:
            return full
        return Batch(*[x[d * per:(d + 1) * per] for x in full])

    padded = ((ids[: batch.batch_size], mine(batch))
              for ids, batch in pipeline.epoch(0))
    for ids, _, on_device in device_prefetch(padded, device):
        correct = eval_step(model, on_device, n_classes, k)["correct"]
        if dp > 1:
            with torch.inference_mode():
                buf = torch.zeros((pad_bs, correct.shape[1]),
                                  dtype=torch.int32, device=device)
                buf[d * per:(d + 1) * per] = correct.to(torch.int32)
                correct = all_reduce_(buf, group)
        c_np = correct.cpu().numpy().astype(np.int32)
        for i, page_id in enumerate(ids):
            rows.append([int(page_id)] + list(c_np[i]))
    if not rows:
        raise ValueError(
            f"{split_name} split is empty: check the fold dir / split files "
            "(evaluating zero pages has no defined accuracy)"
        )
    img_acc = np.array(rows, dtype=np.int32)
    class_acc = np.zeros(n_classes)
    class_acc[1:] = img_acc[:, 1:].mean(0) * 100

    print_and_log(
        "[%s] Avg_class_Accuracy: %.2f%% (%.2fs)"
        % (split_name, class_acc[1:].mean(), time.time() - start),
        log_file,
    )
    for c in range(1, n_classes):
        print_and_log(
            "%s top-%d-Acc: %.2f%%" % (class_names[c], k, class_acc[c]),
            log_file,
        )
    print_and_log("", log_file)
    return img_acc, class_acc


def fit(
    state: TrainState,
    cfg,
    train_pipeline,
    val_pipeline,
    ckpt: CheckpointManager,
    log_file: Optional[str] = None,
    metrics: Optional[MetricsLogger] = None,
    class_names=("BG", "Price", "Title", "Image"),
    resume: bool = False,
) -> Tuple[TrainState, float]:
    """Train with early stopping; returns (the state restored to its best
    checkpoint, the best val accuracy). On a mesh (``state.mesh``),
    ``train_pipeline`` is this rank's stripe (``make_pipelines(...,
    host_shard=mesh.host_shard)``)."""
    metrics = metrics or MetricsLogger(None)
    mesh = state.mesh
    data_group = mesh.data_group if mesh is not None else None
    data_rank = mesh.data_index if mesh is not None else 0
    best_eval_acc = 0.0
    patience_count = 0
    start_epoch = 1

    def bookkeeping(epoch):
        return {"epoch": epoch, "best_eval_acc": best_eval_acc,
                "patience": patience_count}

    if resume and ckpt.exists("last"):
        extra = ckpt.restore("last", state)
        start_epoch = int(extra["epoch"]) + 1
        best_eval_acc = float(extra["best_eval_acc"])
        patience_count = int(extra["patience"])
        print_and_log(
            f"Resuming from epoch {start_epoch} "
            f"(best val {best_eval_acc:.2f})",
            log_file,
        )

    print_and_log("Training Model for %d epochs..." % cfg.n_epochs, None)
    buckets = tuple(cfg.box_buckets)
    stop = False
    for epoch in range(start_epoch, cfg.n_epochs + 1):
        gen = dropout_generator(cfg.seed, epoch, state.device, data_rank)
        start = time.time()
        step_metrics = []
        # Every data rank buckets to the GLOBAL batch's largest box count,
        # which each computes alone.
        global_max = (
            train_pipeline.global_batch_max_counts(epoch)
            if buckets and train_pipeline.shard_count > 1 else None
        )
        padded = (
            (ids, bucket_batch(
                pad_batch(batch, train_pipeline.batch_size)[0], buckets,
                lower_bound=(int(global_max[i])
                             if global_max is not None else 0)))
            for i, (ids, batch) in enumerate(train_pipeline.epoch(epoch))
        )
        for _, _, on_device in device_prefetch(padded, state.device):
            m = train_step(state, on_device, gen)
            step_metrics.append(torch.stack(
                [m["loss_sum"], m["n_correct"], m["n_boxes"]]))
        # One device-to-host fetch per epoch (after one all-reduce of the
        # three sums over the data group).
        loss_sum, n_correct, n_boxes = all_reduce_(
            torch.stack(step_metrics).sum(0), data_group).tolist()
        epoch_secs = time.time() - start
        print_and_log(
            "Epoch: %2d  Loss: %.4f  Accuracy: %.2f%%  (%.2fs)"
            % (epoch, loss_sum / n_boxes, 100 * n_correct / n_boxes,
               epoch_secs),
            log_file,
        )
        metrics.log(
            "train_epoch",
            epoch=epoch,
            loss=loss_sum / n_boxes,
            acc=n_correct / n_boxes,
            seconds=epoch_secs,
            pages_per_sec=len(train_pipeline.ds) / epoch_secs,
        )

        if (
            epoch == 1
            or epoch % cfg.eval_interval == 0
            or epoch == cfg.n_epochs
        ):
            _, class_acc = run_eval(
                state.model, val_pipeline, cfg.n_classes, class_names,
                "VAL", log_file, box_buckets=buckets, mesh=mesh,
            )
            eval_acc = float(class_acc[1:].mean())
            metrics.log("val", epoch=epoch, avg_class_acc=eval_acc)
            if eval_acc > best_eval_acc:
                best_eval_acc = eval_acc
                patience_count = 0
                ckpt.save("best", state, bookkeeping(epoch))
            else:
                patience_count += 1
                if patience_count >= cfg.patience:
                    print_and_log("Early Stopping!", None)
                    stop = True

        ckpt.save("last", state, bookkeeping(epoch))
        if stop:
            break

    print_and_log("Model Trained! Restoring model to best Eval performance "
                  "checkpoint...", None)
    if ckpt.exists("best"):
        ckpt.restore("best", state)
    else:
        # Val accuracy never exceeded 0.0, so no "best" was written (the
        # reference would fail here); save the final state so eval and
        # predict always find a model.
        ckpt.save("best", state, bookkeeping(cfg.n_epochs))
    return state, best_eval_acc
