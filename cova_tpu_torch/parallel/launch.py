"""Start the ranks of a multi-rank run on this host.

``python -m cova_tpu_torch.cli train --num_devices N`` (without a launch in
the environment) calls ``spawn``: N processes of the same command, each
given the launch contract of ``parallel/distributed.py``
(``COVA_COORDINATOR_ADDRESS``, ``COVA_NUM_PROCESSES``, ``COVA_PROCESS_ID``).
The rendezvous store is hosted by the launching process on a port it binds
itself (``rendezvous_store``), as ``torchrun``'s agent does, so no other
process can take the port between its choice and the ranks' start. The
ranks share this process's stdout and stderr. If a rank fails, the others
are stopped rather than left waiting on its collectives.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rendezvous_store():
    """A ``TCPStore`` server on a localhost port that it binds itself (port
    0), hosted by this process: the ranks of ``rank_env(..., store.port)``
    all join it as clients. Keep the object alive until they end."""
    import torch.distributed as dist

    return dist.TCPStore("localhost", 0, is_master=True,
                         wait_for_workers=False)


def rank_env(rank: int, world: int, port: int,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of rank ``rank`` of a ``world``-rank launch whose
    rendezvous store this process hosts on localhost:``port``
    (``rendezvous_store``; the package importable from it).

    ``TORCHELASTIC_USE_AGENT_STORE`` makes every rank a client of that
    store, rank 0 included."""
    env = dict(os.environ if base is None else base)
    env.update(
        COVA_COORDINATOR_ADDRESS=f"localhost:{port}",
        COVA_NUM_PROCESSES=str(world),
        COVA_PROCESS_ID=str(rank),
        TORCHELASTIC_USE_AGENT_STORE="True",
        PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH", "")) if p),
    )
    return env


def wait_all(procs: List[subprocess.Popen],
             timeout: Optional[float] = None) -> List[int]:
    """Wait for every process; when one fails (or ``timeout`` seconds
    pass), terminate the rest. Returns the exit codes."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            late = deadline is not None and time.monotonic() > deadline
            if failed or late:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def spawn(argv: Sequence[str], n: int) -> int:
    """Run ``python -m cova_tpu_torch.cli *argv`` as ``n`` ranks on this
    host; returns 0 if every rank did, else the first failing code."""
    store = rendezvous_store()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cova_tpu_torch.cli", *argv],
            env=rank_env(r, n, store.port),
        )
        for r in range(n)
    ]
    codes = wait_all(procs)
    return next((c for c in codes if c != 0), 0)
