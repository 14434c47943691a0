"""The (data, model) layout of a multi-rank run and the tensor-parallel
slicing of the state.

Counterpart of ``cova_tpu/parallel/mesh.py``. There, one jitted step runs
on a ``jax.sharding.Mesh`` and XLA inserts every collective. Here each
device is a rank of ``torch.distributed``, laid out as
``jax.experimental.mesh_utils.create_device_mesh`` orders a (data, model)
grid: rank = d * n_model + m. A ``Mesh`` holds this rank's coordinates and
two process groups:

  * the data group, the ranks of one model column (same m): batch
    statistics and gradients are summed over it;
  * the model group, the ranks of one data row (same d): the tensor-sharded
    projections gather their outputs over it.

Tensor parallelism: ``gat.W_i``, ``gat.W_j`` and ``decoder.1`` (the JAX
package's ``gat/W_i``, ``gat/W_j`` and ``decoder_hidden/Dense_0`` kernels,
sharded on their output axis) hold ``out / n_model`` rows of their weight,
and ``decoder.1`` of its bias; every other tensor is replicated.
``shard_state_dict`` and ``gather_state_dict`` convert between the full
state_dict (what checkpoints hold, whatever the layout) and a rank's slices,
and ``*_optimizer_state`` do the same for Adam's moments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from . import collectives, distributed

# The port's state_dict keys whose rows (torch's output axis) are split
# over the model axis when the mesh has one.
MODEL_SHARDED = ("gat.W_i.weight", "gat.W_j.weight", "decoder.1.weight",
                 "decoder.1.bias")


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_model: int = 1
    rank: int = 0
    data_group: Optional[object] = None  # None: one data shard, or no groups
    model_group: Optional[object] = None  # None: no tensor parallelism

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def model_root(self) -> int:
        """The global rank of this rank's model group's first member."""
        return self.data_index * self.n_model

    @property
    def host_shard(self):
        """(shard_index, shard_count) of this rank's input stripe: the ranks
        of one data row feed the same pages."""
        return self.data_index, self.n_data


def make_mesh(n_data: int, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over every rank of the default group,
    with its process groups. Every rank must call it, in the same order
    (``new_group`` is collective); outside a launch of n_data * n_model
    ranks it returns the layout alone, without groups."""
    n = n_data * n_model
    if not dist.is_initialized() or dist.get_world_size() != n:
        return Mesh(n_data, n_model)
    mesh = Mesh(n_data, n_model, rank=dist.get_rank())
    # new_group needs every rank to create every group, in one order.
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks) if n_data > 1 else None
        if m == mesh.model_index:
            mesh.data_group = g
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks) if n_model > 1 else None
        if d == mesh.data_index:
            mesh.model_group = g
    return mesh


def mesh_from_config(cfg, n_visible: Optional[int] = None) -> Optional[Mesh]:
    """The (data, model) mesh of a run, or None for the single-device path,
    with the JAX package's validation and messages.

    ``cfg.num_devices``: 0 = every visible device, 1 = one device (no
    mesh), N > 1 = exactly N. ``n_visible`` defaults to the launch's world
    size. ``cfg.model_parallel`` splits the devices into a tensor-parallel
    axis. The global batch must divide over the data axis: the CE-sum loss
    makes the batch dimension semantic, so it is never resized.
    """
    if n_visible is None:
        n_visible = distributed.world_size()
    n = cfg.num_devices
    if n == 0:
        n = n_visible
    if n <= 1:
        return None
    if n > n_visible:
        raise ValueError(
            f"num_devices={n} but only {n_visible} devices are visible"
        )
    n_model = max(1, cfg.model_parallel)
    if n % n_model != 0:
        raise ValueError(
            f"num_devices={n} not divisible by model_parallel={n_model}"
        )
    n_data = n // n_model
    if cfg.batch_size % n_data != 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} must be divisible by the data-"
            f"parallel degree {n_data} (num_devices={n} / "
            f"model_parallel={n_model})"
        )
    if distributed.is_multiprocess() and n != distributed.world_size():
        raise ValueError(
            f"num_devices={n} but the launch has {distributed.world_size()} "
            "ranks (one device each)"
        )
    return make_mesh(n_data, n_model)


def _rows(t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    if t.shape[0] % n != 0:
        raise ValueError(
            f"{tuple(t.shape)} does not split into {n} equal row blocks"
        )
    k = t.shape[0] // n
    return t[i * k:(i + 1) * k]


def shard_state_dict(sd: Mapping[str, torch.Tensor],
                     mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The full state_dict -> this rank's (tensor-sharded keys sliced)."""
    if mesh is None or mesh.n_model == 1:
        return dict(sd)
    return {k: (_rows(v, mesh.n_model, mesh.model_index).clone()
                if k in MODEL_SHARDED else v) for k, v in sd.items()}


def gather_state_dict(sd: Mapping[str, torch.Tensor],
                      mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """This rank's state_dict -> the full one, on every rank of the model
    group (collective over it; the row blocks in rank order)."""
    if mesh is None or mesh.n_model == 1:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        if k in MODEL_SHARDED:
            full = collectives.gather_last(v.detach().t(), mesh.model_group)
            v = full.t().contiguous()
        out[k] = v
    return out


def _param_names(model) -> list:
    return [name for name, _ in model.named_parameters()]


def _map_moments(opt_sd: Mapping, model, fn) -> dict:
    """``opt_sd`` with ``fn(name, tensor)`` applied to every per-parameter
    tensor of its state (Adam's moments)."""
    names = _param_names(model)
    state = {}
    for idx, st in opt_sd["state"].items():
        name = names[int(idx)]
        state[idx] = {k: (fn(name, v) if torch.is_tensor(v) and v.dim() > 0
                          else v) for k, v in st.items()}
    return {"state": state, "param_groups": opt_sd["param_groups"]}


def shard_optimizer_state(opt_sd: Mapping, model,
                          mesh: Optional[Mesh]) -> dict:
    """A full optimizer state_dict -> this rank's (moments of the
    tensor-sharded parameters sliced)."""
    if mesh is None or mesh.n_model == 1:
        return dict(opt_sd)
    return _map_moments(opt_sd, model, lambda name, v: (
        _rows(v, mesh.n_model, mesh.model_index).clone()
        if name in MODEL_SHARDED else v))


def gather_optimizer_state(opt_sd: Mapping, model,
                           mesh: Optional[Mesh]) -> dict:
    """This rank's optimizer state_dict -> the full one (collective over
    the model group)."""
    if mesh is None or mesh.n_model == 1:
        return dict(opt_sd)

    def gather(name, v):
        if name not in MODEL_SHARDED:
            return v
        return collectives.gather_last(
            v.detach().t(), mesh.model_group).t().contiguous()

    return _map_moments(opt_sd, model, gather)


def parallelize(model, mesh: Optional[Mesh]):
    """Lay ``model`` (built whole, the same weights on every rank) out on
    ``mesh`` in place: every ``MaskedBatchNorm`` sums its statistics over
    the data group, and with a model axis the tensor-sharded parameters
    keep this rank's rows and the model gathers their outputs. Create the
    optimizer afterwards. Returns ``model``."""
    from ..models.layers import MaskedBatchNorm

    if mesh is None:
        return model
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.group = mesh.data_group
    if mesh.n_model > 1:
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name in MODEL_SHARDED:
                if name in params:
                    p = params[name]
                    p.data = _rows(p.data, mesh.n_model,
                                   mesh.model_index).clone()
        model.tp_group = mesh.model_group
        if getattr(model, "gat", None) is not None:
            model.gat.tp_group = mesh.model_group
    return model


def full_state_dict(model, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The model's whole state_dict, whatever its layout (collective over
    the model group)."""
    return gather_state_dict(model.state_dict(), mesh)


def load_full_state_dict(model, sd: Mapping[str, torch.Tensor],
                         mesh: Optional[Mesh]) -> None:
    """Strict-load a whole state_dict into a model laid out on ``mesh``."""
    model.load_state_dict(shard_state_dict(sd, mesh), strict=True)
