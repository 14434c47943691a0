"""Eval-mode BatchNorm affine + residual + ReLU in one pass: the CUDA kernel
K9 of ``csrc/bn_act.cu`` and its plain PyTorch version.

Replaces no TPU kernel (XLA fuses these ops for the JAX package). In the
trunk's blocks (``models/resnet.py``) an eval-mode ``MaskedBatchNorm``
is a fixed per-channel affine, ``scale`` and ``shift`` from
``MaskedBatchNorm(..., return_coefficients=True)``; the block's ReLU and
its residual add (the residual itself BN'd where a downsample exists)
follow. ``bn_act_plain`` is that composition as the modules compute it,

    y = (x.float() * scale + shift).to(x.dtype)
    r = res or (res.float() * res_scale + res_shift).to(res.dtype)
    y = relu(y + r)

and the kernel equals it bit for bit, NaNs and signed zeros included: it
rounds where the plain version rounds and keeps the multiply and the add
two rounded steps.

``bn_act`` runs the kernel on a CUDA tensor where no gradient is needed
(grad mode off, or no input requiring grad), and ``bn_act_plain``
otherwise: on the CPU, and where autograd has to see the ops.
``launch_plan`` picks the kernel's vector width and grid.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

_FNS = {torch.bfloat16: "bn_act_bf16", torch.float32: "bn_act_f32"}
# The kernel's threads per block and the blocks it keeps on an SM
# (``kThreads`` and ``kMinBlocks`` in ``csrc/bn_act.cu``); the H100's SMs.
THREADS = 256
BLOCKS_PER_SM = 2
N_SMS = 132
_VEC = 8
_VEC_BYTES = 16


class Plan(NamedTuple):
    vec: int  # channels a thread loads at once: 8, or 1 (the scalar walk)
    blocks: int  # the grid


def launch_plan(numel: int, c: int, aligned: bool) -> Plan:
    """The kernel's plan for ``numel`` elements of ``c`` channels:
    8-channel vectors where ``c % 8 == 0`` and every map pointer is 16-byte
    aligned (``aligned``), else scalars; a thread a vector up to
    ``BLOCKS_PER_SM`` blocks an SM, and at least enough threads to cover
    one pixel's vectors (each thread keeps one channel vector)."""
    vec = _VEC if aligned and c % _VEC == 0 else 1
    blocks = min(-(-numel // vec // THREADS), BLOCKS_PER_SM * N_SMS)
    return Plan(vec, max(blocks, -(-(c // vec) // THREADS)))


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 *, relu: bool, res: Optional[torch.Tensor] = None,
                 res_scale: Optional[torch.Tensor] = None,
                 res_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu?(bn(x) + res?)`` through the modules' own PyTorch ops and
    order (differentiable, any device)."""
    y = (x.float() * scale + shift).to(x.dtype)
    if res is not None:
        if res_scale is not None:
            res = (res.float() * res_scale + res_shift).to(res.dtype)
        y = y + res
    return F.relu(y) if relu else y


def _check(x, scale, shift, res, res_scale, res_shift) -> int:
    if x.dtype not in _FNS:
        raise TypeError(f"bn_act: unsupported dtype {x.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if c == 0:
        raise ValueError(f"bn_act: need [..., C] with C > 0; got "
                         f"{tuple(x.shape)}")
    for name, t in (("scale", scale), ("shift", shift),
                    ("res_scale", res_scale), ("res_shift", res_shift)):
        if t is not None and (t.shape != (c,) or t.device != x.device):
            raise ValueError(f"bn_act: {name} must be [{c}] on {x.device}")
    if (res_scale is None) != (res_shift is None) or (
            res is None and res_scale is not None):
        raise ValueError("bn_act: res_scale and res_shift come together, "
                         "with res")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype
                            or res.device != x.device):
        raise ValueError("bn_act: res must match x in shape, dtype and "
                         "device")
    for t in (x, res):
        if t is not None and not t.is_contiguous():
            raise ValueError("bn_act: x and res must be contiguous")
    return c


def _bind(lib) -> None:
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _launch(x, scale, shift, res, res_scale, res_shift,
            relu: bool) -> torch.Tensor:
    """The kernel on CUDA tensors."""
    c = _check(x, scale, shift, res, res_scale, res_shift)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    coef = [t.detach().to(torch.float32).contiguous()
            for t in (scale, shift)]
    rcoef = [None, None] if res_scale is None else [
        t.detach().to(torch.float32).contiguous()
        for t in (res_scale, res_shift)]
    plan = launch_plan(x.numel(), c, aligned=all(
        t.data_ptr() % _VEC_BYTES == 0
        for t in (x, res, out) if t is not None))
    mode = 0 if res is None else (1 if res_scale is None else 2)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library("bn_act", _bind)
    with torch.cuda.device(x.device):
        rc = getattr(lib, _FNS[x.dtype])(
            x.data_ptr(), coef[0].data_ptr(), coef[1].data_ptr(), ptr(res),
            ptr(rcoef[0]), ptr(rcoef[1]), out.data_ptr(), x.numel(), c,
            plan.vec, mode, int(relu), plan.blocks, _build.stream_ptr(x))
    _build.check(rc, "bn_act")
    bn_act.launches += 1
    return out


def bn_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
           relu: bool, res: Optional[torch.Tensor] = None,
           res_scale: Optional[torch.Tensor] = None,
           res_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu?(x * scale + shift + res?)`` with each step rounded to
    x.dtype as the modules round it; ``res`` optionally BN'd by
    (``res_scale``, ``res_shift``).

    x, res: [..., C] bf16 or f32; scale, shift, res_scale, res_shift: [C]
    f32. K9 on a CUDA tensor when no gradient is needed, else
    ``bn_act_plain``.
    """
    ts = (x, scale, shift, res, res_scale, res_shift)
    if x.device.type != "cuda" or (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts)):
        return bn_act_plain(x, scale, shift, relu=relu, res=res,
                            res_scale=res_scale, res_shift=res_shift)
    return _launch(*ts, relu)


bn_act.launches = 0
