"""Multi-process initialization: the process group and each rank's
device.

Counterpart of ``cova_tpu/parallel/distributed.py``, with the same manual
launcher contract: every rank runs the same program with

  * ``COVA_COORDINATOR_ADDRESS`` (``host:port`` of rank 0's rendezvous),
  * ``COVA_NUM_PROCESSES`` (the world size) and
  * ``COVA_PROCESS_ID`` (this rank),

and, optionally, ``COVA_DIST_INIT_TIMEOUT`` (seconds; the rendezvous and
every collective give up after it). ``initialize()`` wires
``torch.distributed`` from them; without ``COVA_COORDINATOR_ADDRESS`` it is
a no-op, so one code path serves one device and many.

Backend: NCCL where each rank has a card of its own; gloo on ``--device
cpu`` and where ranks share a card (NCCL refuses two ranks on one device;
gloo's ``all_reduce`` and ``broadcast`` take CUDA tensors, and the port's
collectives use nothing else). A backend that fails to initialise raises:
no rank falls back to one process.

A rank's device is ``cuda:(local_rank % device_count)``; ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` (torchrun's names) give the rank and the rank count
on this host where they differ from the global ones (several hosts). A
rank's stripe of the input is its mesh's (``parallel.mesh.Mesh.host_shard``:
the ranks of one data row read the same pages), in place of the JAX
package's ``host_shard_args``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_backend: Optional[str] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def launched() -> bool:
    """True when the environment carries a multi-process launch."""
    return bool(os.environ.get("COVA_COORDINATOR_ADDRESS"))


def local_rank() -> int:
    v = _env_int("LOCAL_RANK")
    return rank() if v is None else v


def choose_backend(device: torch.device, n_local: int) -> str:
    """gloo on the CPU and where the ``n_local`` ranks of this host share
    cards (more ranks than cards, or one card named for all: ``cuda:0``);
    NCCL where each has its own."""
    if device.type != "cuda":
        return "gloo"
    if n_local > torch.cuda.device_count():
        return "gloo"
    if device.index is not None and n_local > 1:
        return "gloo"
    return "nccl"


def rank_device(name: str) -> torch.device:
    """This rank's device for ``--device name``: ``cuda`` becomes
    ``cuda:(local_rank % device_count)``; an explicit index or ``cpu`` is
    kept."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and is_multiprocess():
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def initialize(
    device: str = "cuda",
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Create the default process group of a multi-process launch.

    * explicit coordinator arguments -> a group from them;
    * none, but ``COVA_COORDINATOR_ADDRESS`` set -> coordinator, world size
      and rank from ``COVA_{COORDINATOR_ADDRESS,NUM_PROCESSES,PROCESS_ID}``;
    * neither -> a no-op (one process).

    ``device`` is the ``--device`` of the run; it picks the backend.
    Idempotent: once a group exists, repeat calls return at once.
    """
    global _backend
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("COVA_COORDINATOR_ADDRESS")
        if not coordinator_address:
            return
        if num_processes is None:
            num_processes = _env_int("COVA_NUM_PROCESSES")
        if process_id is None:
            process_id = _env_int("COVA_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(
            f"a launch through {coordinator_address!r} needs "
            "COVA_NUM_PROCESSES and COVA_PROCESS_ID"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"COVA_PROCESS_ID={process_id} is outside a world of "
            f"{num_processes}"
        )
    timeout = _env_int("COVA_DIST_INIT_TIMEOUT")
    n_local = _env_int("LOCAL_WORLD_SIZE") or num_processes
    dev = torch.device(device if not device.isdigit() else f"cuda:{device}")
    backend = choose_backend(dev, n_local)
    if dev.type == "cuda" and dev.index is None:
        lr = _env_int("LOCAL_RANK")
        lr = process_id if lr is None else lr
        torch.cuda.set_device(lr % torch.cuda.device_count())
    elif dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # CPU ranks of one host share its cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_local))
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        **kwargs,
    )
    _backend = backend


def backend() -> Optional[str]:
    """The default group's backend, or None in a single process."""
    return _backend if dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    """True when this run spans more than one process."""
    return world_size() > 1


def is_primary() -> bool:
    """True on the rank that owns stdout and the artifact files (rank 0)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in a single process). An all-reduce of
    one element, so that gloo and NCCL behave alike on any device."""
    if not is_multiprocess():
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend() == "nccl" else torch.device("cpu"))
    dist.all_reduce(torch.zeros(1, device=dev))


def shutdown() -> None:
    """Destroy the default process group, if any."""
    global _backend
    if dist.is_initialized():
        dist.destroy_process_group()
    _backend = None
