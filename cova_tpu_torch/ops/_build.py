"""Build the CUDA kernels under ``csrc/`` at first use and bind them with
ctypes.

Each ``csrc/<name>.cu`` exports plain C functions (pointers, ints and the
stream; no PyTorch headers), so ``nvcc`` builds it in seconds. Every source
is compiled by its own ``nvcc`` process, all started together, into
``csrc/build/<hash>/lib<name>.so``; the hash covers the source and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
directory is listed in ``.gitignore``.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("roi_pool", "bn_pool", "conv3x3")
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


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, key.hexdigest()[:16], f"lib{name}.so")


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library, one
    ``nvcc`` per source, in parallel. Returns {name: ptxas report} for the
    sources it compiled; raises with the compiler's output on failure."""
    todo = [n for n in names if not os.path.isfile(_lib_path(n))]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


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
