"""Shifted-window multi-head self-attention of a Swin block: the CUDA kernel
K10 of ``csrc/window_attn.cu`` and its plain PyTorch version.

Replaces no TPU kernel (neither package had an attention trunk). The
attention of the detection backbone's ``SwinTransformerBlock`` (Liu et al.
2021, arXiv 2103.14030; ``mmdet/models/backbones/swin_transformer.py``),
which pads the normed map at the bottom and right to a multiple of the
window, rolls it by ``-shift`` (in the shifted block), cuts it into
windows, attends within each window with a relative-position bias (and,
shifted, -100 between tokens of different shift regions), then merges the
windows, rolls back and crops. A pad token's normed value is zero, so its
q, k and v are the qkv Linear's bias, and it is attended as a key.

Both versions take the qkv of the unpadded map, ``qkv`` [B, H, W, 3 C]
(q, k, v, each ``heads`` x ``C / heads``), the bias gathered from its
table, ``bias`` [heads, 49, 49] f32 (``relative_bias``), the qkv Linear's
bias ``pad_qkv`` [3 C] (the pad tokens' qkv) and the shift, and return
[B, H, W, C] in qkv's dtype at the unshifted positions.

* ``window_attention_plain`` runs the published sequence literally in f32
  (the qkv map padded with the pad tokens' qkv, which is the qkv of the
  zero-padded normed map): the CPU path and the oracle on the card.
* ``window_attention`` launches K10 on a CUDA tensor (bf16, window 7, 3
  heads of 32, no gradient: K10 has no backward) or raises, and runs the
  plain version on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

WINDOW = 7
HEADS, HEAD_DIM = 3, 32  # what K10 is built for (csrc/window_attn.cu)
MASK_VALUE = -100.0  # the published attn_mask's value across shift regions


def relative_position_index(window: int = WINDOW) -> torch.Tensor:
    """The published ``relative_position_index`` [w^2, w^2] int64: the
    row of the bias table for each pair of tokens of a window."""
    coords = torch.stack(torch.meshgrid(
        torch.arange(window), torch.arange(window), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def relative_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The bias [heads, n, n] f32 of a table [(2w-1)^2, heads] under the
    index [n, n]."""
    n = index.shape[0]
    return table[index.reshape(-1)].reshape(n, n, -1).permute(
        2, 0, 1).float().contiguous()


def _regions(padded: int, shift: int, window: int) -> torch.Tensor:
    """The shift region of each coordinate of a rolled, padded side: the
    published slices (0, -window), (-window, -shift), (-shift, end)."""
    s = torch.arange(padded)
    return (s >= padded - window).long() + (s >= padded - shift).long()


def shift_mask(hp: int, wp: int, shift: int,
               window: int = WINDOW) -> torch.Tensor:
    """The published ``attn_mask`` [windows, n, n] of a padded map: -100
    between tokens of different shift regions, else 0."""
    region = (_regions(hp, shift, window)[:, None] * 3
              + _regions(wp, shift, window)[None, :])
    win = _partition(region[None, :, :, None].float(), window)[..., 0]
    return torch.where(win[:, :, None] != win[:, None, :], MASK_VALUE, 0.0)


def _partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, Hp, Wp, C] -> [B * windows, window^2, C], windows row-major."""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _reverse(x: torch.Tensor, b: int, hp: int, wp: int,
             window: int) -> torch.Tensor:
    """``_partition``'s inverse."""
    c = x.shape[-1]
    x = x.reshape(b, hp // window, wp // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


def padded_side(n: int, window: int = WINDOW) -> int:
    return -(-n // window) * window


def attend(qkv_windows: torch.Tensor, bias: torch.Tensor, mask,
           heads: int) -> torch.Tensor:
    """Attention within each window of [B * windows, n, 3 C] (f32), with
    ``bias`` [heads, n, n] and ``mask`` [windows, n, n] or None ->
    [B * windows, n, C]."""
    bw, n, c3 = qkv_windows.shape
    c = c3 // 3
    qkv = qkv_windows.reshape(bw, n, 3, heads, c // heads).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None]
        attn = attn.reshape(bw, heads, n, n)
    attn = torch.softmax(attn, -1)
    return (attn @ v).transpose(1, 2).reshape(bw, n, c)


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           pad_qkv: torch.Tensor, shift: int,
                           window: int = WINDOW) -> torch.Tensor:
    """The published sequence in f32: pad (the pad tokens' qkv), roll by
    -shift, partition, masked softmax attention, reverse, roll back, crop."""
    b, h, w, c3 = qkv.shape
    hp, wp = padded_side(h, window), padded_side(w, window)
    x = F.pad(qkv.float(), (0, 0, 0, wp - w, 0, hp - h))
    real = ((torch.arange(hp, device=x.device) < h)[:, None]
            & (torch.arange(wp, device=x.device) < w)[None, :])
    x = torch.where(real[None, :, :, None], x, pad_qkv.float())
    mask = None
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        mask = shift_mask(hp, wp, shift, window).to(x.device)
    y = attend(_partition(x, window), bias.float(), mask, bias.shape[0])
    y = _reverse(y, b, hp, wp, window)
    if shift > 0:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    return y[:, :h, :w].to(qkv.dtype).contiguous()


def _bind(lib) -> None:
    fn = lib.window_attn_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch(qkv, bias, pad_qkv, shift: int) -> torch.Tensor:
    """K10 on CUDA tensors."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"window_attention: K10 takes bfloat16, not "
                        f"{qkv.dtype} (run the trunk in bfloat16 compute)")
    b, h, w, c3 = qkv.shape if qkv.dim() == 4 else (0, 0, 0, 0)
    if c3 != 3 * HEADS * HEAD_DIM or not qkv.is_contiguous() \
            or qkv.data_ptr() % 16:
        raise ValueError(f"window_attention: K10 needs a contiguous, "
                         f"16-byte aligned [B, H, W, {3 * HEADS * HEAD_DIM}] "
                         f"qkv; got {tuple(qkv.shape)}")
    n = WINDOW * WINDOW
    if bias.shape != (HEADS, n, n) or bias.device != qkv.device:
        raise ValueError(f"window_attention: bias must be [{HEADS}, {n}, "
                         f"{n}] on {qkv.device}")
    if pad_qkv.shape != (c3,) or pad_qkv.device != qkv.device:
        raise ValueError(f"window_attention: pad_qkv must be [{c3}] on "
                         f"{qkv.device}")
    if not 0 <= shift < WINDOW:
        raise ValueError(f"window_attention: shift {shift} not in [0, "
                         f"{WINDOW})")
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    bias = bias.detach().to(torch.float32).contiguous()
    # A fresh tensor: 16-byte aligned, as the kernel's copies need.
    pad = pad_qkv.detach().to(torch.bfloat16).clone()
    lib = _build.library("window_attn", _bind)
    with torch.cuda.device(qkv.device):
        rc = lib.window_attn_bf16(
            qkv.data_ptr(), bias.data_ptr(), pad.data_ptr(), out.data_ptr(),
            b, h, w, shift, HEAD_DIM ** -0.5, _build.stream_ptr(qkv))
    _build.check(rc, "window_attention")
    window_attention.launches += 1
    return out


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     pad_qkv: torch.Tensor, shift: int) -> torch.Tensor:
    """The block's windowed attention, [B, H, W, 3 C] -> [B, H, W, C]: K10
    on a CUDA tensor (or raises), ``window_attention_plain`` on the CPU."""
    if qkv.device.type != "cuda":
        return window_attention_plain(qkv, bias, pad_qkv, shift)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, bias, pad_qkv)):
        raise NotImplementedError(
            "window_attention: K10 (csrc/window_attn.cu) has no backward, so "
            "the swin_t_stage1 trunk serves on the card but trains only on "
            "the CPU")
    return _launch(qkv, bias, pad_qkv, shift)


window_attention.launches = 0
