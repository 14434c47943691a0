"""One train step of a fixed global batch on a mesh, for holding a layout
against the single-device step (and the JAX package's mesh step).

    python -m cova_tpu_torch.parallel.step_check DIR     # as every rank

``DIR`` holds ``spec.json`` (``config``: ``Config`` fields; ``layouts``: a
list of ``[n_data, n_model]`` whose product is the launch's world size;
``device``; ``seed``; optionally ``dtypes``, compute dtypes to run each
layout in (default: the config's), and ``timing``: ``{"warmup": w,
"reps": r}``),
``weights.pt`` (a whole state_dict) and ``batch.npz`` (the global batch, the
fields of ``data.batching.Batch``). For each layout every rank builds the
model from the weights, lays it out (``parallel.mesh.parallelize``), takes
its rows of the batch (data rank d: rows ``[d * B/n_data, (d+1) *
B/n_data)``) and runs ``forward_backward`` (gradients summed over the data
group) and the Adam step. Rank 0 writes ``<n_data>x<n_model>.<dtype>.pt``:
the global loss sum, every parameter's gradient before the step and the
state after it, gathered whole. Every rank writes
``<n_data>x<n_model>.<dtype>.rank<r>.json``: the kernel launches of its step
(counted from 0 over it), and with ``timing`` the host-clock ms per step
(mean of ``reps`` after ``warmup``) and the gradient collectives' ms and
bytes (``reduce_gradients``). ``run_layout`` does the same in one process (no mesh).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.batching import Batch
from ..models.cova import build_model
from ..train.steps import (
    create_train_state,
    forward_backward,
    reduce_gradients,
    train_step,
)
from . import collectives, distributed
from .mesh import Mesh, full_state_dict, make_mesh


def _wrappers():
    """The kernel wrappers that count their launches, by kernel name."""
    from ..ops import bn_pool, roi_pool

    return {"roi_pool_fwd": roi_pool.roi_pool,
            "roi_pool_bwd": roi_pool.roi_pool_backward,
            "bn_relu_pool_fwd": bn_pool.bn_relu_pool_s2d,
            "bn_relu_pool_bwd": bn_pool.bn_relu_pool_s2d_backward}


def _zero_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _launches() -> Dict[str, int]:
    return {k: int(fn.launches) for k, fn in _wrappers().items()}


def load_batch(path: str) -> Batch:
    with np.load(path) as z:
        return Batch(*[z[f] for f in Batch._fields])


def save_batch(path: str, batch: Batch) -> None:
    np.savez(path, **{f: np.asarray(v) for f, v in zip(Batch._fields,
                                                       batch)})


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _full_grads(model, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient, the tensor-sharded ones gathered."""
    from .mesh import MODEL_SHARDED

    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if mesh is not None and mesh.n_model > 1 and name in MODEL_SHARDED:
            g = collectives.gather_last(g.t(), mesh.model_group).t()
        out[name] = g.float().cpu().clone()
    return out


def run_layout(cfg: Config, sd, batch: Batch, device, seed: int,
               mesh: Optional[Mesh] = None, timing=None) -> dict:
    """The step of ``batch`` (global) from the weights ``sd`` on ``mesh``
    (None: one process). Returns ``loss_sum`` (global), ``grads`` and
    ``state`` (whole, on the CPU), ``launches`` (this rank's) and, with
    ``timing``, ``ms_per_step``, ``grad_sync_ms``, ``allreduce_bytes`` and
    ``broadcast_bytes``. In f32, TF32 is off (as the CLI sets it) for the
    call."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if cfg.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run_layout(cfg, sd, batch, device, seed, mesh, timing)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _run_layout(cfg, sd, batch, device, seed, mesh, timing) -> dict:
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.to(device)
    state = create_train_state(model, cfg, mesh)
    if mesh is not None:
        per = batch.batch_size // mesh.n_data
        d = mesh.data_index
        batch = Batch(*[x[d * per:(d + 1) * per] for x in batch])
    gen = torch.Generator(device=device).manual_seed(seed)
    _sync(device)
    _zero_launches()
    m = forward_backward(state, batch, gen)
    _sync(device)
    launches = _launches()
    loss = m["loss_sum"].detach().reshape(1).clone()
    collectives.all_reduce_(loss, None if mesh is None else mesh.data_group)
    grads = _full_grads(state.model, mesh)
    state.optimizer.step()
    out = dict(loss_sum=float(loss), grads=grads, launches=launches,
               state={k: v.detach().cpu().clone() for k, v in
                      full_state_dict(state.model, mesh).items()})
    if timing:
        distributed.barrier()
        for _ in range(timing["warmup"]):
            train_step(state, batch, gen)
        _sync(device)
        distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(timing["reps"]):
            train_step(state, batch, gen)
        _sync(device)
        out["ms_per_step"] = (time.perf_counter() - t0) / timing["reps"] * 1e3
        times, nbytes = [], {}
        for _ in range(timing["reps"]):
            forward_backward(state, batch, gen)
            _sync(device)
            distributed.barrier()
            t0 = time.perf_counter()
            nbytes = reduce_gradients(state.model, mesh)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        # The gradient collectives of one step: the data group's all-reduce
        # and, with a model axis, the replicated part's broadcast.
        out["grad_sync_ms"] = float(np.mean(times)) if mesh else 0.0
        out.update(nbytes)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m cova_tpu_torch.parallel."
                         "step_check DIR")
    root = argv[0]
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    distributed.initialize(spec["device"])
    try:
        device = distributed.rank_device(spec["device"])
        cfg = Config(**spec["config"])
        sd = torch.load(os.path.join(root, "weights.pt"), map_location="cpu",
                        weights_only=True)
        batch = load_batch(os.path.join(root, "batch.npz"))
        runs = [(dt, layout) for dt in spec.get("dtypes",
                                                [cfg.compute_dtype])
                for layout in spec["layouts"]]
        for dtype, (n_data, n_model) in runs:
            mesh = make_mesh(n_data, n_model)
            if mesh.data_group is None and mesh.model_group is None:
                raise SystemExit(f"layout {n_data}x{n_model} needs a launch "
                                 f"of {n_data * n_model} ranks")
            res = run_layout(cfg.replace(compute_dtype=dtype), sd, batch,
                             device, spec["seed"], mesh, spec.get("timing"))
            tag = os.path.join(root, f"{n_data}x{n_model}.{dtype}")
            r = distributed.rank()
            with open(f"{tag}.rank{r}.json", "w") as f:
                json.dump({k: res[k] for k in res
                           if k not in ("grads", "state")}, f)
            if distributed.is_primary():
                torch.save({k: res[k] for k in ("loss_sum", "grads",
                                                "state")}, f"{tag}.pt")
        distributed.barrier()
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
