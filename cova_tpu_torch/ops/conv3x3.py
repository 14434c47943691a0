"""3x3 stride-1 same conv over NHWC maps as nine shifted matrix products:
the CUDA kernels of ``csrc/conv3x3.cu`` and their plain PyTorch version.

Counterpart of ``cova_tpu/ops/conv3x3.py``, with its names:

  * ``conv3x3(x, w)``: the input-stationary kernel (``_kernel`` there), a
    ``torch.autograd.Function``. Its dx is the same kernel on the spatially
    flipped, io-transposed weights; its dW is one library conv whose
    contraction runs over batch and space, as the JAX package leaves it to
    XLA.
  * ``conv3x3_roll(x, w)``: the output-stationary kernel (``_roll_kernel``),
    forward only.
  * ``conv3x3_reference(x, w)``: the plain version, nine shifted
    ``[B*H*W, C] @ [C, O]`` products summed in f32 in (dy, dx) order and
    rounded once.
  * ``use_cuda_conv()`` / ``conv3x3_auto(x, w)``: the opt-in gate
    (``COVA_CUDA_CONV=1``, off by default, where ``F.conv2d`` runs).

x: [B, H, W, C]; w: [3, 3, C, O] (HWIO), cast to x.dtype first; the result
is [B, H, W, O] in x.dtype. On a CUDA tensor ``conv3x3`` and
``conv3x3_roll`` launch their kernel or raise (bf16 and f32, C and O
multiples of 16); on a CPU tensor they run the plain version.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from . import _build
from .conv_stem import nhwc_conv2d

_FWD_FNS = {torch.float32: "conv3x3_fwd_f32",
            torch.bfloat16: "conv3x3_fwd_bf16"}
_ROLL_FNS = {torch.float32: "conv3x3_roll_fwd_f32",
             torch.bfloat16: "conv3x3_roll_fwd_bf16"}
# Input channels a block holds in shared memory at a time, largest first.
_C_CHUNKS = {torch.float32: (32, 16), torch.bfloat16: (64, 48, 32, 16)}
_O_CHUNKS = (64, 48, 32, 16)
# The batch is a grid dimension, and so is the number of output chunks.
_MAX_GRID = 65535


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: zero-pad, nine shifted matrix products summed in f32
    in (dy, dx) order, one rounding to x.dtype."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    w = w.to(x.dtype)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b * h * wd, o), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            a = xp[:, dy : dy + h, dx : dx + wd, :].reshape(b * h * wd, c)
            acc += (a.float() @ w[dy, dx].float())
    return acc.to(x.dtype).reshape(b, h, wd, o)


def _chunk(n: int, options) -> int:
    """The largest of ``options`` that divides ``n``."""
    for k in options:
        if n % k == 0:
            return k
    raise ValueError(f"conv3x3: {n} channels is not a multiple of 16")


def _bind(lib) -> None:
    for name in (*_FWD_FNS.values(), *_ROLL_FNS.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int


def _launch(x: torch.Tensor, w: torch.Tensor, fns, what: str) -> torch.Tensor:
    """Check the operands and launch one of the two forward kernels."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{what}: unsupported devices {x.device}, {w.device}")
    if x.dtype not in fns:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"{what}: need x [B, H, W, C] and w [3, 3, C, O]; "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, c = x.shape
    o = w.shape[-1]
    kc, oc = _chunk(c, _C_CHUNKS[x.dtype]), _chunk(o, _O_CHUNKS)
    if min(b, h, wd) < 1 or b > _MAX_GRID or o // oc > _MAX_GRID:
        raise ValueError(f"{what}: need 1 <= B <= {_MAX_GRID} and a non-empty "
                         f"map; got {tuple(x.shape)}")
    x = x.detach().contiguous()
    w = w.detach().to(x.dtype).contiguous()
    out = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    if x.data_ptr() % 16 or w.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    lib = _build.library("conv3x3", _bind)
    with torch.cuda.device(x.device):
        rc = getattr(lib, fns[x.dtype])(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, o, kc,
            oc, _build.stream_ptr(x),
        )
    _build.check(rc, what)
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input-stationary forward without autograd: the plain version on
    the CPU, the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    out = _launch(x, w, _FWD_FNS, "conv3x3")
    conv3x3.launches += 1
    return out


def _flip_io(w: torch.Tensor) -> torch.Tensor:
    """The kernel of the input gradient: spatially flipped, with input and
    output channels exchanged."""
    return torch.flip(w, (0, 1)).transpose(2, 3)


def conv3x3_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW [3, 3, C, O] of ``conv3x3`` for the cotangent ``g`` [B, H, W, O]:
    one library conv that contracts over batch and space with f32
    accumulation."""
    c, o = x.shape[-1], g.shape[-1]
    dw = torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2), (o, c, 3, 3), g.to(x.dtype).permute(0, 3, 1, 2),
        padding=1,
    )
    return dw.permute(2, 3, 1, 0)


class _Conv3x3(torch.autograd.Function):
    """Autograd over a forward implementation (kernel or plain version); the
    JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, w, fwd):
        ctx.fwd = fwd
        ctx.save_for_backward(x, w)
        return fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ctx.fwd(g.to(x.dtype).contiguous(), _flip_io(w))
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad(x, g).to(w.dtype)
        return dx, dw, None


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 same conv, NHWC. x: [B, H, W, C]; w: [3, 3, C, O].
    Differentiable in both; dx is skipped where x needs no gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3.apply(x, w, _forward)
    return _forward(x, w)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3x3`` through the plain version on any device: the same
    function and gradient rule, with no kernel launched."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3.apply(x, w, conv3x3_reference)
    return conv3x3_reference(x, w)


def conv3x3_roll(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The output-stationary 3x3 conv (the dx shift applied on the f32
    output side). Forward only, as in the JAX package."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    out = _launch(x, w, _ROLL_FNS, "conv3x3_roll")
    conv3x3_roll.launches += 1
    return out


def use_cuda_conv() -> bool:
    """Kernel path gate, off by default: ``COVA_CUDA_CONV=1`` sends every
    stride-1 3x3 conv of the model through ``conv3x3``."""
    return os.environ.get("COVA_CUDA_CONV") == "1"


def conv3x3_auto(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The model's stride-1 3x3 conv. Opt-in off: ``F.conv2d``. Opt-in on:
    ``conv3x3`` for a CUDA tensor (which launches or raises), the plain
    version for a CPU tensor."""
    if not use_cuda_conv():
        return nhwc_conv2d(x, w.permute(3, 2, 0, 1), padding=1)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    return conv3x3(x, w)


conv3x3.launches = 0
conv3x3_roll.launches = 0
