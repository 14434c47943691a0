"""LayerNorm over the 96 channels of a Swin token map, with the residual add
before it folded in: the CUDA kernel K11 of ``csrc/layernorm.cu`` and its
plain PyTorch version.

Replaces no TPU kernel (neither package had a LayerNorm trunk). In the Swin
trunk (``models/swin.py``) every residual add ``x + branch`` is followed at
once by a LayerNorm, so one call takes both: ``y = LN(x + res)``, and
optionally the sum ``x + res``, the residual stream the trunk carries on.
The LayerNorm is the module's as the trunk runs it: its weight and bias cast
to x's dtype, its ``eps``.

* ``layernorm_plain`` runs the sequence as PyTorch ops, ``x + res`` then
  ``F.layer_norm``: the CPU path (differentiable) and the oracle on the
  card.
* ``layernorm`` launches K11 on a CUDA tensor (bf16, 96 channels,
  contiguous and 16-byte aligned maps, no gradient: K11 has no backward) or
  raises, and runs the plain version on the CPU.

K11's sum equals ``x + res`` bit for bit; its output differs from
``F.layer_norm``'s only by the order of the f32 statistics' sums, at most
one bf16 step.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build

CHANNELS = 96  # what K11 is built for (csrc/layernorm.cu)
_ALIGN = 16

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    res: Optional[torch.Tensor] = None, *,
                    sum_out: bool = False) -> Out:
    """``F.layer_norm(x + res)`` over the last dimension, with ``weight``
    and ``bias`` cast to x's dtype; with ``sum_out``, also ``x + res``."""
    s = x if res is None else x + res
    y = F.layer_norm(s, (s.shape[-1],), weight.to(s.dtype),
                     bias.to(s.dtype), eps)
    return (y, s) if sum_out else y


def check(x, weight, bias, res=None) -> None:
    """What K11 takes; raises on anything else (on any device, so that the
    rules can be tested without a card)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, res)):
        raise NotImplementedError(
            "layernorm: K11 (csrc/layernorm.cu) has no backward, so the "
            "swin_t_stage1 trunk serves on the card but trains only on the "
            "CPU")
    for t in (x, res):
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"layernorm: K11 takes bfloat16, not {t.dtype} "
                            f"(run the trunk in bfloat16 compute)")
    if x.dim() == 0 or x.shape[-1] != CHANNELS:
        raise ValueError(f"layernorm: K11 takes [..., {CHANNELS}]; got "
                         f"{tuple(x.shape)}")
    if res is not None and (res.shape != x.shape or res.device != x.device):
        raise ValueError("layernorm: res must match x in shape and device")
    for t in (x, res):
        if t is not None and (not t.is_contiguous()
                              or t.data_ptr() % _ALIGN):
            raise ValueError("layernorm: K11 needs contiguous, 16-byte "
                             "aligned maps")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (CHANNELS,) or t.device != x.device:
            raise ValueError(f"layernorm: {name} must be [{CHANNELS}] on "
                             f"{x.device}")


def _bind(lib) -> None:
    fn = lib.swin_layernorm_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch(x, weight, bias, eps: float, res, sum_out: bool) -> Out:
    """K11 on CUDA tensors that ``check`` passed."""
    y = torch.empty_like(x)
    s = torch.empty_like(x) if sum_out and res is not None else None
    if x.numel():
        # f32 parameters pass as they are: the kernel rounds them to bf16.
        w, b = (t.detach().to(torch.float32).contiguous()
                for t in (weight, bias))
        lib = _build.library("layernorm", _bind)
        with torch.cuda.device(x.device):
            rc = lib.swin_layernorm_bf16(
                x.data_ptr(), None if res is None else res.data_ptr(),
                w.data_ptr(), b.data_ptr(), y.data_ptr(),
                None if s is None else s.data_ptr(), x.numel() // CHANNELS,
                eps, _build.stream_ptr(x))
        _build.check(rc, "layernorm")
        layernorm.launches += 1
    if not sum_out:
        return y
    return y, (x if res is None else s)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float, res: Optional[torch.Tensor] = None, *,
              sum_out: bool = False) -> Out:
    """``LN(x + res)`` over the last dimension with the module's ``weight``,
    ``bias`` and ``eps`` (``res`` None: ``LN(x)``); with ``sum_out``,
    ``(y, x + res)``. K11 on a CUDA tensor (or raises),
    ``layernorm_plain`` on the CPU."""
    if x.device.type != "cuda":
        return layernorm_plain(x, weight, bias, eps, res, sum_out=sum_out)
    check(x, weight, bias, res)
    return _launch(x, weight, bias, eps, res, sum_out)


layernorm.launches = 0
