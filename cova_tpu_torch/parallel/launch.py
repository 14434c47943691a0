"""Start the ranks of a multi-rank run on this host.

``python -m cova_tpu_torch.cli train --num_devices N`` (without a launch in
the environment) calls ``spawn``: N processes of the same command, each
given the launch contract of ``parallel/distributed.py``
(``COVA_COORDINATOR_ADDRESS`` on a free localhost port,
``COVA_NUM_PROCESSES``, ``COVA_PROCESS_ID``). The ranks share this
process's stdout and stderr. If a rank fails, the others are stopped rather
than left waiting on its collectives.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of rank ``rank`` of a ``world``-rank launch whose
    rendezvous is localhost:``port`` (the package importable from it)."""
    env = dict(os.environ if base is None else base)
    env.update(
        COVA_COORDINATOR_ADDRESS=f"localhost:{port}",
        COVA_NUM_PROCESSES=str(world),
        COVA_PROCESS_ID=str(rank),
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
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "cova_tpu_torch.cli", *argv],
            env=rank_env(r, n, port),
        )
        for r in range(n)
    ]
    codes = wait_all(procs)
    return next((c for c in codes if c != 0), 0)
