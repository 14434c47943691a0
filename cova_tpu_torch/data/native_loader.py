"""ctypes bindings for the repo's native host runtime
(``native/cova_native.cpp``): PNG screenshot decode on a libpng + pthread
pool, and bbox-CSV parsing.

Counterpart of ``cova_tpu/data/native_loader.py``, with its own build: the
port reads ``native/cova_native.cpp`` and writes nothing under ``native/``.
``ensure_built`` compiles the source with the recipe of ``native/Makefile``
into ``data/build/<hash>/libcova_native.so`` (the hash covers the source,
the compiler and its flags; the directory is listed in ``.gitignore``) by
the kernels' recipe (``ops/_build.py:compile_all``: a temporary file,
renamed into place under a file lock, so processes that build at once
never load half a file). Until a build exists,
``available()`` is False and ``WebDataset`` decodes with PIL instead (same
pixels).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from ..ops._build import OUT, compile_all, hashed_path

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "cova_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-Wall")
LDLIBS = ("-lpng", "-lpthread")

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> str:
    """Where this source, compiler and flags build the library."""
    return hashed_path(BUILD_DIR, "libcova_native.so",
                       (_cxx(), *CXXFLAGS, *LDLIBS), [SOURCE])


def build() -> str:
    """Compile the library unless it exists; returns its path. Raises
    ``RuntimeError`` with the compiler's output (``OSError`` without a
    compiler)."""
    out = lib_path()
    compile_all({"cova_native": (
        out, [_cxx(), *CXXFLAGS, "-o", OUT, SOURCE, *LDLIBS])})
    return out


def load_library(path: Optional[str] = None) -> Optional[ctypes.CDLL]:
    """Load (and memoize) the native library; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB is not None:
        return _LIB
    if _LIB_TRIED and path is None:
        return None
    _LIB_TRIED = True
    try:
        lib = ctypes.CDLL(path or lib_path())
    except OSError:
        return None
    try:
        _bind(lib)
    except AttributeError:
        # A stale build that lacks a newer symbol: use the PIL path.
        return None
    _LIB = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.cova_decode_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.cova_decode_png.restype = ctypes.c_int
    lib.cova_decode_png_batch_ex.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.cova_decode_png_batch_ex.restype = ctypes.c_int
    lib.cova_parse_bbox_csv.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.cova_parse_bbox_csv.restype = ctypes.c_int


def available() -> bool:
    return load_library() is not None


def decode_png(path: str, h: int, w: int) -> np.ndarray:
    """Decode one PNG to uint8 [h, w, 3] (zero-pad/crop to the target)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (ensure_built())")
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.cova_decode_png(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        h,
        w,
    )
    if rc != 0:
        raise IOError(f"cova_decode_png({path}) failed with code {rc}")
    return out


def decode_png_batch(
    paths: Sequence[str], h: int, w: int, nthreads: int = 4,
    s2d4: bool = False,
) -> np.ndarray:
    """Decode a batch of PNGs with a C thread pool. Returns uint8
    [n, h, w, 3], or with ``s2d4=True`` (h, w % 4 == 0) the model's input
    layout [n, h/4, w/4, 48], rearranged in C right after each decode."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (ensure_built())")
    if s2d4 and (h % 4 or w % 4):
        raise ValueError(f"s2d4 requires h, w % 4 == 0, got ({h}, {w})")
    n = len(paths)
    shape = (n, h // 4, w // 4, 48) if s2d4 else (n, h, w, 3)
    out = np.empty(shape, dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.cova_decode_png_batch_ex(
        arr,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        h,
        w,
        nthreads,
        1 if s2d4 else 0,
    )
    if failures < 0:
        raise ValueError(f"cova_decode_png_batch_ex error code {failures}")
    if failures:
        raise IOError(f"{failures}/{n} PNG decodes failed")
    return out


def parse_bbox_csv(path: str, max_rows: int = 4096) -> np.ndarray:
    """Parse a bbox CSV (header + rows x,y,w,h,label) -> float32 [n, 5]."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (ensure_built())")
    buf = np.empty((max_rows, 5), dtype=np.float32)
    n = lib.cova_parse_bbox_csv(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows,
    )
    if n < 0:
        raise IOError(f"cova_parse_bbox_csv({path}) failed with code {n}")
    return buf[:n].copy()


def ensure_built() -> bool:
    """Build (once) and load the library if a toolchain is available."""
    if available():
        return True
    try:
        build()
    except (RuntimeError, OSError):
        return False
    global _LIB_TRIED
    _LIB_TRIED = False
    return available()
