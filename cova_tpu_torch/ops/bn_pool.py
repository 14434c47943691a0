"""Fused BatchNorm-normalize + ReLU + 3x3/2 max-pool over the stem's s2d(2)
output, forward and backward: the CUDA kernels of ``csrc/bn_pool.cu`` and
their plain PyTorch versions.

Counterpart of ``cova_tpu/ops/bn_pool.py`` (``_fwd_kernel`` and
``_bwd_kernel`` with their ``custom_vjp``). ``scale`` and ``shift`` are the
effective per-channel BN affine from
``MaskedBatchNorm(..., return_coefficients=True)``:
``y = x * scale + shift == (x - mean) * rsqrt(var + eps) * gamma + beta``.

``bn_relu_pool_s2d`` is differentiable in ``ys``, ``scale`` and ``shift``:
when grad is enabled and an input requires it, it runs as an autograd
function whose backward is ``bn_relu_pool_s2d_backward``. That backward
follows the JAX kernel's tie rule, not autograd of the plain forward (which
would split ties evenly): along columns and rows the shifted candidate wins
ties, across the four phase groups the lowest group index that attains the
max wins, and gradient flows only where the pooled max is > 0.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version. The forward kernel equals the plain
version bit for bit, and so does the backward's ``dys``; ``dscale`` and
``dshift`` are sums over the whole map taken in another order (see the notes
in ``csrc/bn_pool.cu``). ``bn_relu_pool_s2d_plain`` is the same autograd
function over the plain versions, on any device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .conv_stem import stem_pool_s2d

_FNS = {torch.float32: "bn_relu_pool_fwd_f32",
        torch.bfloat16: "bn_relu_pool_fwd_bf16"}
_BWD_FNS = {torch.float32: "bn_relu_pool_bwd_f32",
            torch.bfloat16: "bn_relu_pool_bwd_bf16"}
# Blocks of the backward kernel: each walks the map with a grid stride and
# writes one row of d(scale)/d(shift) partials, summed here afterwards.
_BWD_MAX_BLOCKS = 2048


def bn_relu_pool_s2d_reference(
    ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``stem_pool_s2d(relu(ys * tile(scale, 4) +
    tile(shift, 4)))``, the affine in f32 and cast back to ys.dtype before
    the pool, as the JAX package's unfused path does.

    ys: [B, U, V, 4*O]; scale, shift: [O]. Returns [B, U, V, O].
    """
    z = ys.float() * scale.float().repeat(4) + shift.float().repeat(4)
    return stem_pool_s2d(F.relu(z).to(ys.dtype))


def _prev(t: torch.Tensor, dim: int, fill: float) -> torch.Tensor:
    """``out[i] = t[i - 1]`` along ``dim``, with ``out[0] = fill``."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [1, 0]
    return F.pad(t, pad, value=fill).narrow(dim, 0, t.shape[dim])


def _next(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``out[i] = t[i + 1]`` along ``dim``, with 0 past the end."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, 1]
    return F.pad(t, pad).narrow(dim, 1, t.shape[dim])


def bn_relu_pool_s2d_backward_reference(
    ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    g: torch.Tensor,
):
    """Plain version of the backward, with the JAX kernel's tie rule and its
    order of sums (``cova_tpu/ops/bn_pool.py::_bwd_kernel``).

    ys: [B, U, V, 4*O]; scale, shift: [O]; g: [B, U, V, O], the cotangent of
    the pooled map. Returns (dys [B, U, V, 4*O] in ys.dtype, dscale [O] f32,
    dshift [O] f32).
    """
    b, u, v, c4 = ys.shape
    o = c4 // 4
    x = ys.float().reshape(b, u, v, 4, o)
    z = x * scale.float() + shift.float()  # the forward's affine, [.., 4, O]
    grp = torch.arange(4, device=ys.device)[:, None]
    ex, ey = (grp % 2) == 1, grp >= 2
    ninf = float("-inf")
    # Column stage: on ex = 1 groups, block column j-1 competes and wins ties.
    zl = _prev(z, 2, ninf)
    colsel = ex & (zl >= z)
    zc = torch.where(colsel, zl, z)
    # Row stage: on ey = 1 groups, block row i-1 competes and wins ties.
    zu = _prev(zc, 1, ninf)
    rowsel = ey & (zu >= zc)
    zrc = torch.where(rowsel, zu, zc)
    # Phase stage: the lowest group index that attains the max.
    m = zrc.amax(3, keepdim=True)
    eq = zrc >= m
    sel = eq & (eq.int().cumsum(3) == 1)
    routed = torch.where(sel & (m > 0), g.float()[:, :, :, None, :], 0.0)
    # Un-route rows (the a-side stays in row i, the b-side goes to i-1),
    # then columns (a col-selected value belongs to column j-1).
    ga = torch.where(rowsel, 0.0, routed)
    gb = torch.where(rowsel, routed, 0.0)
    dzc = ga + _next(gb, 1)
    dpre = torch.where(colsel, 0.0, dzc) + _next(
        torch.where(colsel, dzc, 0.0), 2)
    dys = (dpre * scale.float()).reshape(b, u, v, c4).to(ys.dtype)
    dscale = (dpre * x).sum((0, 1, 2, 3))
    dshift = dpre.sum((0, 1, 2, 3))
    return dys, dscale, dshift


def _check(ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           what: str, fns) -> int:
    if ys.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ys.device}")
    c4 = ys.shape[-1]
    o = c4 // 4
    if ys.dtype not in fns:
        raise TypeError(f"{what}: unsupported dtype {ys.dtype}")
    if ys.dim() != 4 or c4 != 4 * o or o % 2:
        raise ValueError(f"{what}: need [B, U, V, 4*O] with O even; got "
                         f"{tuple(ys.shape)}")
    if not ys.is_contiguous() or ys.data_ptr() % 8:
        raise ValueError(f"{what}: ys must be contiguous and aligned")
    if scale.shape != (o,) or shift.shape != (o,):
        raise ValueError(f"{what}: scale/shift must be [{o}]")
    return o


def _bind(lib) -> None:
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    for name in _BWD_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int


def _forward(ys: torch.Tensor, scale: torch.Tensor,
             shift: torch.Tensor) -> torch.Tensor:
    """The forward without autograd: the plain version on the CPU, the
    kernel on a CUDA tensor."""
    if ys.device.type == "cpu":
        return bn_relu_pool_s2d_reference(ys, scale, shift)
    o = _check(ys, scale, shift, "bn_relu_pool_s2d", _FNS)
    b, u, v, _ = ys.shape
    scale = scale.detach().to(torch.float32).contiguous()
    shift = shift.detach().to(torch.float32).contiguous()
    out = torch.empty((b, u, v, o), dtype=ys.dtype, device=ys.device)
    lib = _build.library("bn_pool", _bind)
    with torch.cuda.device(ys.device):
        rc = getattr(lib, _FNS[ys.dtype])(
            ys.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, u, v, o, _build.stream_ptr(ys),
        )
    _build.check(rc, "bn_relu_pool_s2d")
    bn_relu_pool_s2d.launches += 1
    return out


def bn_relu_pool_s2d_backward(
    ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    g: torch.Tensor,
):
    """Backward of ``bn_relu_pool_s2d``: (dys in ys.dtype, dscale [O] f32,
    dshift [O] f32) for the cotangent ``g`` [B, U, V, O] of the pooled map.
    The kernel on a CUDA tensor, the plain version on the CPU."""
    if ys.device.type == "cpu":
        return bn_relu_pool_s2d_backward_reference(ys, scale, shift, g)
    o = _check(ys, scale, shift, "bn_relu_pool_s2d_backward", _BWD_FNS)
    b, u, v, c4 = ys.shape
    if g.shape != (b, u, v, o):
        raise ValueError(f"bn_relu_pool_s2d_backward: g must be "
                         f"[{b}, {u}, {v}, {o}], got {tuple(g.shape)}")
    half = o // 2
    if half > 256:
        raise ValueError("bn_relu_pool_s2d_backward: at most 512 channels")
    scale = scale.detach().to(torch.float32).contiguous()
    shift = shift.detach().to(torch.float32).contiguous()
    g = g.detach().to(ys.dtype).contiguous()
    threads = half * (256 // half)
    n_blocks = max(1, min(_BWD_MAX_BLOCKS,
                          -(-b * u * v * half // threads)))
    dys = torch.empty_like(ys)
    partial = torch.empty((n_blocks, 2, c4), dtype=torch.float32,
                          device=ys.device)
    lib = _build.library("bn_pool", _bind)
    with torch.cuda.device(ys.device):
        rc = getattr(lib, _BWD_FNS[ys.dtype])(
            ys.data_ptr(), scale.data_ptr(), shift.data_ptr(), g.data_ptr(),
            dys.data_ptr(), partial.data_ptr(), b, u, v, o, n_blocks,
            _build.stream_ptr(ys),
        )
    _build.check(rc, "bn_relu_pool_s2d_backward")
    bn_relu_pool_s2d_backward.launches += 1
    sums = partial.sum(0).reshape(2, 4, o).sum(1)  # fold the phase groups
    return dys, sums[0], sums[1]


class _BnReluPool(torch.autograd.Function):
    """Autograd over a (forward, backward) pair; saves ys, scale and shift,
    as the JAX VJP does, and recomputes the winners in the backward."""

    @staticmethod
    def forward(ctx, ys, scale, shift, fwd, bwd):
        ctx.bwd = bwd
        ctx.save_for_backward(ys, scale, shift)
        return fwd(ys, scale, shift)

    @staticmethod
    def backward(ctx, g):
        ys, scale, shift = ctx.saved_tensors
        dys, dscale, dshift = ctx.bwd(ys, scale, shift, g.contiguous())
        return (dys, dscale.to(scale.dtype), dshift.to(shift.dtype), None,
                None)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def bn_relu_pool_s2d(
    ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
) -> torch.Tensor:
    """relu(3x3/2-maxpool(ys * scale + shift)) on the s2d(2) stem layout.

    ys: [B, U, V, 4*O] bf16 or f32, channel order (ey, ex, f); scale,
    shift: [O]. Returns [B, U, V, O] in ys.dtype. Differentiable in all
    three inputs (the backward kernel on CUDA).
    """
    if _needs_grad(ys, scale, shift):
        return _BnReluPool.apply(ys, scale, shift, _forward,
                                 bn_relu_pool_s2d_backward)
    return _forward(ys, scale, shift)


def bn_relu_pool_s2d_plain(
    ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
) -> torch.Tensor:
    """``bn_relu_pool_s2d`` through the plain forward and backward on any
    device: the same function and gradients, with no kernel launched."""
    if _needs_grad(ys, scale, shift):
        return _BnReluPool.apply(ys, scale, shift,
                                 bn_relu_pool_s2d_reference,
                                 bn_relu_pool_s2d_backward_reference)
    return bn_relu_pool_s2d_reference(ys, scale, shift)


bn_relu_pool_s2d.launches = 0
bn_relu_pool_s2d_backward.launches = 0
