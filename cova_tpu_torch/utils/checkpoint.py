"""Checkpoints of a train state: the best one and the last one.

Counterpart of ``cova_tpu/utils/checkpoint.py``, with ``torch.save`` in
place of orbax. ``<results_dir>/Fold-<k> saved_model.pt/`` holds ``best.pt``
and ``last.pt``; each is a dict of

  * ``model``: the model's ``state_dict`` in the reference namespace (the
    file a reference user loads with ``model.load_state_dict(ckpt["model"])``);
  * ``optimizer``: the optimizer's ``state_dict`` (Adam moments and steps);
  * ``step``: the number of train steps taken;
  * ``extra``: the trainer's bookkeeping (``epoch``, ``best_eval_acc``,
    ``patience``),

so ``--resume`` continues a run exactly. A file is written to a temporary
name and renamed, so a run cut during a save leaves the previous one.

On a mesh (``state.mesh``) the file is the same as a single device's: every
rank takes part in gathering the tensor-sharded parameters and their Adam
moments, rank 0 writes the whole state, and a barrier follows; on restore
every rank reads the file and keeps its own slices. So a checkpoint
trained on any layout loads into any other, one device included.
"""

from __future__ import annotations

import os

import torch

from ..parallel import distributed
from ..parallel.mesh import (
    gather_optimizer_state,
    load_full_state_dict,
    full_state_dict,
    shard_optimizer_state,
)


class CheckpointManager:
    """One 'best' checkpoint and one 'last' (resume) checkpoint."""

    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.dir, f"{tag}.pt")

    def exists(self, tag: str) -> bool:
        return os.path.isfile(self.path(tag))

    def save(self, tag: str, state, extra: dict) -> None:
        mesh = getattr(state, "mesh", None)
        model = full_state_dict(state.model, mesh)
        optimizer = gather_optimizer_state(state.optimizer.state_dict(),
                                           state.model, mesh)
        if distributed.is_primary():
            tmp = f"{self.path(tag)}.{os.getpid()}.tmp"
            torch.save({
                "model": model,
                "optimizer": optimizer,
                "step": int(state.step),
                "extra": dict(extra),
            }, tmp)
            os.replace(tmp, self.path(tag))
        distributed.barrier()

    def restore(self, tag: str, state) -> dict:
        """Load checkpoint ``tag`` into ``state`` in place: model, optimizer
        and step (this rank's slices on a mesh). Returns its ``extra``
        dict."""
        mesh = getattr(state, "mesh", None)
        ckpt = load_checkpoint(self.path(tag))
        load_full_state_dict(state.model, ckpt["model"], mesh)
        state.optimizer.load_state_dict(
            shard_optimizer_state(ckpt["optimizer"], state.model, mesh))
        state.step = int(ckpt["step"])
        return ckpt["extra"]


def load_checkpoint(path: str) -> dict:
    """A checkpoint file's dict, tensors on the CPU (plain data only:
    ``weights_only`` refuses arbitrary pickled objects)."""
    return torch.load(path, map_location="cpu", weights_only=True)
