"""Build the CUDA kernels under ``csrc/`` at first use and bind them with
ctypes.

Each ``csrc/<name>.cu`` exports plain C functions (pointers, ints and the
stream; no PyTorch headers), so ``nvcc`` builds it in seconds. Every source
is compiled by its own ``nvcc`` process, all started together, into
``csrc/build/<hash>/lib<name>.so``; the hash covers the source, the
headers of ``csrc/`` (``hopper.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused. The directory is listed
in ``.gitignore``. ``hashed_path`` and ``compile_all`` are that recipe; the
port's host library (``data/native_loader.py``) is built by it too.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("roi_pool", "bn_pool", "conv3x3", "bn_act", "window_attn",
           "layernorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of cova_tpu_torch are built on "
        "the machine with the card (set CUDA_HOME or put nvcc on PATH)"
    )


# Stands for the output file in a ``compile_all`` command.
OUT = "{out}"


def hashed_path(build_dir: str, name: str, flags: Sequence[str],
                sources: Sequence[str]) -> str:
    """``build_dir/<hash>/name``, the hash over ``flags`` and each source's
    file name and bytes."""
    key = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            key.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(build_dir, key.hexdigest()[:16], name)


def _discard(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def compile_all(jobs: Dict[str, Tuple[str, Sequence[str]]]) -> Dict[str, str]:
    """Build each ``{name: (out, command)}`` whose ``out`` is missing, one
    compiler process each, all started together; ``OUT`` in a command
    stands for its output file. Each writes a temporary file, renamed into
    place under an flock on ``out + ".lock"``, so threads and processes
    that build at once build each output once and never load half a file.
    Returns {name: compiler output} for what it built; raises
    ``RuntimeError`` with the output of each that failed."""
    import fcntl

    procs, reports, failed = {}, {}, []
    with contextlib.ExitStack() as stack:
        # One order for the locks, so two builders never wait on each other.
        for name, (out, cmd) in sorted(jobs.items(), key=lambda j: j[1][0]):
            if os.path.isfile(out):
                continue
            os.makedirs(os.path.dirname(out), exist_ok=True)
            lock = stack.enter_context(open(out + ".lock", "w"))
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if os.path.isfile(out):  # built while this one waited
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            stack.callback(_discard, tmp)
            procs[name] = (subprocess.Popen(
                [tmp if a == OUT else a for a in cmd], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name} (rc {proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)
            reports[name] = log
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return reports


def _lib_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return hashed_path(BUILD_DIR, f"lib{name}.so", NVCC_FLAGS,
                       [os.path.join(CSRC, f) for f in (f"{name}.cu",
                                                         *headers)])


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library, one
    ``nvcc`` per source, in parallel. Returns {name: ptxas report} for the
    sources it compiled; raises with the compiler's output on failure."""
    todo = [n for n in names if not os.path.isfile(_lib_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    return compile_all({
        name: (_lib_path(name), [nvcc, *NVCC_FLAGS, "-o", OUT,
                                 os.path.join(CSRC, f"{name}.cu")])
        for name in todo})


def library(name: str, bind) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built if needed; ``bind(lib)``
    declares its functions' argtypes once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            bind(lib)
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
