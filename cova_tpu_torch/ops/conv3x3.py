"""3x3 stride-1 same conv over NHWC maps as nine shifted matrix products:
the CUDA kernels of ``csrc/conv3x3.cu``, their launch plan and their plain
PyTorch versions.

Counterpart of ``cova_tpu/ops/conv3x3.py``, with its names:

  * ``conv3x3(x, w)``: the input-stationary kernel (``_kernel`` there), a
    ``torch.autograd.Function``. Its dx is the same kernel on the spatially
    flipped, io-transposed weights; its dW is one library conv whose
    contraction runs over batch and space, as the JAX package leaves it to
    XLA.
  * ``conv3x3_roll(x, w)``: the output-stationary kernel (``_roll_kernel``),
    forward only.
  * ``conv3x3_reference(x, w)``: the plain version of both, nine shifted
    ``[B*H*W, C] @ [C, O]`` products summed in f32 in (dy, dx) order and
    rounded once. It is all the CPU runs.
  * ``launch_plan(kernel, dtype, b, h, w, c, o)``: what the launcher is
    told for a shape (channel chunks, whether the weights stay in shared
    memory, ring stages, shared-memory bytes), and ``tile_walk(plan, ...)``:
    which block stores which output pixels.
  * ``conv3x3_tiled_reference`` / ``conv3x3_roll_tiled_reference``: plain
    versions that follow the bf16 kernels' decomposition step by step (tile
    walk, zero-filled boxes, per-tap products; the roll kernel's panel and
    its carry between the tiles of a row). The tests use them to check the
    index arithmetic where there is no card.
  * ``conv3x3_split_tf32_reference``: the f32 kernels' arithmetic in plain
    PyTorch (each operand split into a TF32 hi, rounded to nearest, and the
    rest; three products summed in f32). The tests use it to show that the
    split holds f32's tolerance where one TF32 pass does not.
  * ``use_cuda_conv()`` / ``conv3x3_auto(x, w)``: the opt-in gate
    (``COVA_CUDA_CONV=1``, off by default, where ``F.conv2d`` runs).

x: [B, H, W, C]; w: [3, 3, C, O] (HWIO), cast to x.dtype first; the result
is [B, H, W, O] in x.dtype. On a CUDA tensor ``conv3x3`` and
``conv3x3_roll`` launch their kernel or raise (bf16 and f32, C and O
multiples of 16); on a CPU tensor they run the plain version.

The kernels are built for Hopper: persistent blocks of two consumer
warpgroups and a producer warp, TMA loads into a ring of shared-memory
stages with zero fill outside the image, ``wgmma`` products with B read
from shared memory in the 128-byte swizzle, f32 accumulators stored from
registers. bf16 reads A from shared memory too; f32 runs split TF32 (three
tensor-core passes, A split in registers, the weights split into hi and lo
planes in shared memory). Every shape the wrapper takes goes to them;
which of two modes runs is chosen here, by shape: where the weights of the
block's output chunk fit beside a two-stage ring (bf16: C in one chunk of
up to 64; f32: the hi and lo planes of every 32-channel chunk) they stay in
shared memory for all its tiles; else each ring stage carries its weight
chunk. ``csrc/conv3x3.cu`` says what bounds each on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_stem import nhwc_conv2d

_FWD_FNS = {torch.float32: "conv3x3_fwd_f32",
            torch.bfloat16: "conv3x3_fwd_bf16"}
_ROLL_FNS = {torch.float32: "conv3x3_roll_fwd_f32",
             torch.bfloat16: "conv3x3_roll_fwd_bf16"}
KERNELS = ("conv3x3", "conv3x3_roll")

# The constants of csrc/conv3x3.cu.
SMEM_MAX = 232_448          # shared memory a block can ask for
SWIZZLE_ROW = 128           # bytes: 64 bf16 or 32 f32 channels of a row
SWIZZLE_ATOM = 1024         # bytes: 8 swizzle rows; stage bases lie on it
MAX_STAGES = 4
K7_TILE = (16, 16)          # output rows, columns of a tile
K7_F32_TILE = (16, 8)
K8_TILE = (2, 64)           # output rows of a strip, columns of a tile
F32_CHUNK = 32              # f32 channels of a chunk: one swizzle row
_BF16_C_CHUNKS = (64, 48, 32, 16)
_BF16_O_CHUNKS = (64, 32, 16)
# f32: K8's panels leave no room for 32 output channels beside the weights.
_F32_O_CHUNKS = {"conv3x3": (32, 16), "conv3x3_roll": (16,)}
_MAX_ITEMS = 2 ** 31 - 1


class LaunchPlan(NamedTuple):
    """What the launcher is told for one shape."""

    kernel: str        # "conv3x3" or "conv3x3_roll"
    dtype: torch.dtype
    kc: int            # input channels of a chunk (bf16: divides C; f32:
                       # 32, the last chunk zero-filled beyond C)
    oc: int            # output channels of a chunk; divides O
    n_cc: int
    n_oc: int
    stationary: bool   # the weights stay in shared memory across tiles
    stages: int        # ring stages
    smem_bytes: int
    tile: Tuple[int, int]   # output rows, columns a work step stores
    box: Tuple[int, int]    # input rows, columns a stage holds
    stage_bytes: int        # bytes of a ring stage (input and its weights)
    weight_bytes: int       # bytes of one weight plane of a chunk:
                            # [9, oc, one swizzle row]
    planes: int             # weight planes: 1 (bf16), 2 (f32: hi and lo)


def _chunk(n: int, options) -> int:
    """The largest of ``options`` that divides ``n``."""
    for k in options:
        if n % k == 0:
            return k
    raise ValueError(f"conv3x3: {n} channels is not a multiple of 16")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=256)
def launch_plan(kernel: str, dtype: torch.dtype, b: int, h: int, w: int,
                c: int, o: int) -> LaunchPlan:
    """The launch plan of ``kernel`` for x [b, h, w, c] -> o channels.
    Raises for what the kernels do not take."""
    if kernel not in KERNELS:
        raise ValueError(f"conv3x3: no kernel {kernel!r}")
    if dtype not in _FWD_FNS:
        raise TypeError(f"{kernel}: unsupported dtype {dtype}")
    if min(b, h, w) < 1:
        raise ValueError(f"{kernel}: need a non-empty batch and map; got "
                         f"{(b, h, w, c)}")
    roll = kernel == "conv3x3_roll"
    f32 = dtype == torch.float32
    if f32:
        kc, planes = F32_CHUNK, 2
        _chunk(c, (16,))  # raises unless C is a multiple of 16
        n_cc = -(-c // kc)
    else:
        kc, planes = _chunk(c, _BF16_C_CHUNKS), 1
        n_cc = c // kc
    if roll:
        tile, box = K8_TILE, (K8_TILE[0] + 2, K8_TILE[1])
        items = b * -(-h // tile[0])
    else:
        tile = K7_F32_TILE if f32 else K7_TILE
        box = (tile[0] + 2, tile[1] + 2)
        items = b * -(-h // tile[0]) * -(-w // tile[1])
    if items > _MAX_ITEMS:
        raise ValueError(f"{kernel}: {items} work items exceed {_MAX_ITEMS}")
    input_bytes = _round_up(box[0] * box[1] * SWIZZLE_ROW, SWIZZLE_ATOM)
    barriers = 8 * (2 * MAX_STAGES + 1)

    def fit(oc, stationary):
        weights = 9 * oc * SWIZZLE_ROW
        panels = 2 * (68 + 66) * (oc + 8) * 4 if roll else 0
        fixed = (SWIZZLE_ATOM + panels + barriers
                 + (planes * n_cc * weights if stationary else 0))
        stage = input_bytes + (0 if stationary else planes * weights)
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // stage)
        return LaunchPlan(kernel, dtype, kc, oc, n_cc, o // oc, stationary,
                          stages, fixed + stages * stage, tile, box, stage,
                          weights, planes)

    if f32:
        # The weights stay wherever their hi and lo planes leave room for a
        # two-stage ring.
        oc = _chunk(o, _F32_O_CHUNKS[kernel])
        plan = fit(oc, True)
        if plan.stages < 2:
            plan = fit(oc, False)
    else:
        stationary = n_cc == 1
        plan = fit(_chunk(o, _BF16_O_CHUNKS if stationary
                          else _BF16_O_CHUNKS[1:]), stationary)
    if plan.stages < 2:
        raise ValueError(f"{kernel}: no room for a two-stage ring")
    return plan


def tile_walk(plan: LaunchPlan, b: int, h: int, w: int, n_sms: int = 132
              ) -> List[List[Tuple[int, int, int, int, int, int]]]:
    """Per block, the output regions it stores, in order, as (o0, image, y0,
    y1, x0, x1), clipped to the map: ``n_oc * n_walkers`` persistent blocks;
    block i keeps output chunk ``i % n_oc`` and walks the work items
    ``i // n_oc, + n_walkers, ...``."""
    th, tw = plan.tile
    ty, tx = -(-h // th), -(-w // tw)

    def regions(o0, bi, y, x0, x1):
        return o0, bi, y * th, min(h, (y + 1) * th), max(0, x0), min(w, x1)

    roll = plan.kernel == "conv3x3_roll"
    items = b * ty * (1 if roll else tx)
    walkers = max(1, min(items, n_sms // plan.n_oc))
    blocks = []
    for i in range(plan.n_oc * walkers):
        o0, mine = (i % plan.n_oc) * plan.oc, []
        for item in range(i // plan.n_oc, items, walkers):
            if not roll:
                x, rest = item % tx, item // tx
                mine.append(regions(o0, rest // ty, rest % ty, x * tw,
                                    (x + 1) * tw))
                continue
            # A tile of a strip stores the columns one to the left of its
            # input columns; the tile that ends with the row stores the last.
            for x in range(tx):
                x1 = (x + 1) * tw - 1
                mine.append(regions(o0, item // ty, item % ty, x * tw - 1,
                                    x1 + (x1 + 1 == w)))
        blocks.append(mine)
    return blocks


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


def _tf32(t: torch.Tensor, nearest: bool) -> torch.Tensor:
    """f32 values with their low 13 mantissa bits cleared: rounded to TF32
    to nearest with ties away from zero (``cvt.rna.tf32.f32``), or cut, as
    the tensor cores read an f32 operand."""
    bits = t.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def conv3x3_split_tf32_reference(x: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """The f32 kernels' arithmetic: x and w split as v = hi + lo (hi = v
    rounded to TF32 to nearest, lo the rest, read as TF32), nine shifted
    products each taken as hi * hi + hi * lo + lo * hi (exact products of
    TF32 values), summed in f32. x: f32."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    w = w.to(x.dtype)
    xh, wh = _tf32(x, True), _tf32(w, True)
    xl, wl = _tf32(x - xh, False), _tf32(w - wh, False)
    pads = [F.pad(t, (0, 0, 1, 1, 1, 1)) for t in (xh, xl)]
    acc = torch.zeros((b * h * wd, o), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            ah, al = (p[:, dy : dy + h, dx : dx + wd, :].reshape(-1, c)
                      for p in pads)
            acc += ah @ wh[dy, dx]
            acc += ah @ wl[dy, dx]
            acc += al @ wh[dy, dx]
    return acc.reshape(b, h, wd, o)


def _zero_filled_box(img: torch.Tensor, y0: int, x0: int, rows: int,
                     cols: int, c0: int) -> torch.Tensor:
    """What one TMA load delivers: the box [rows, cols, 64 channels] of
    ``img`` [H, W, C] at the signed corner (y0, x0, c0), zeros outside."""
    h, w, c = img.shape
    box = torch.zeros((rows, cols, 64), dtype=img.dtype)
    ya, yb = max(y0, 0), min(y0 + rows, h)
    xa, xb = max(x0, 0), min(x0 + cols, w)
    ca = min(c0 + 64, c)
    if ya < yb and xa < xb:
        box[ya - y0 : yb - y0, xa - x0 : xb - x0, : ca - c0] = img[
            ya:yb, xa:xb, c0:ca]
    return box


def conv3x3_tiled_reference(x: torch.Tensor, w: torch.Tensor,
                            n_sms: int = 132) -> torch.Tensor:
    """``conv3x3`` the way the bf16 input-stationary kernel computes it:
    persistent blocks walk 16 x 16 tiles; a stage is the tile's halo box
    (18 x 18 pixels x 64 channels, zero-filled outside the image and beyond
    C); each warpgroup owns 8 tile rows as two 8 x 8 sub-tiles, and a tap
    (dy, dx) of a sub-tile is the product of the 64 pixels at halo rows
    8 wg + dy .., columns 8 half + dx .. with the tap's weight chunk. f32
    sums, one rounding, stores masked at the right and bottom edges."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    plan = launch_plan("conv3x3", torch.bfloat16, b, h, wd, c, o)
    w = w.to(x.dtype)
    # The kernel's weight operand: [3, 3, O, C], each tap transposed.
    wt = w.permute(0, 1, 3, 2).contiguous().float()
    out = torch.full((b, h, wd, o), float("nan"), dtype=x.dtype)
    (th, tw), ks = plan.tile, plan.kc
    for block in tile_walk(plan, b, h, wd, n_sms):
        for o0, bi, y0, y1, x0, x1 in block:
            acc = torch.zeros((2, 2, 64, plan.oc))  # [wg, half, m, n]
            for cc in range(plan.n_cc):
                halo = _zero_filled_box(x[bi], y0 - 1, x0 - 1, th + 2, tw + 2,
                                        cc * ks).float()
                wk = wt[:, :, o0 : o0 + plan.oc, cc * ks : (cc + 1) * ks]
                for wg in range(2):
                    for half in range(2):
                        for dy in range(3):
                            for dx in range(3):
                                a = halo[8 * wg + dy : 8 * wg + dy + 8,
                                         8 * half + dx : 8 * half + dx + 8,
                                         :ks].reshape(64, ks)
                                acc[wg, half] += a @ wk[dy, dx].T
            for wg in range(2):
                for half in range(2):
                    sub = acc[wg, half].reshape(8, 8, plan.oc).to(x.dtype)
                    ya, xa = y0 + 8 * wg, x0 + 8 * half
                    ny, nx = min(8, h - ya), min(8, wd - xa)
                    if ny > 0 and nx > 0:
                        out[bi, ya : ya + ny, xa : xa + nx,
                            o0 : o0 + plan.oc] = sub[:ny, :nx]
    return out


def conv3x3_roll_tiled_reference(x: torch.Tensor, w: torch.Tensor,
                                 n_sms: int = 132) -> torch.Tensor:
    """``conv3x3_roll`` the way the bf16 output-stationary kernel computes
    it: a work item is a strip of two output rows (one per warpgroup) over
    the whole width, in tiles of 64 input columns. Per tile, P_j (j = dx)
    sums the un-shifted products of input rows y - 1 .. y + 1 with
    W[dy, j]; P_0 and P_1 go into panels one and two slots down, and the
    tile stores out[x0 - 1 + q] = P_0[q - 2] + P_1[q - 1] + P_2[q]. Slots 64
    and up are the next tile's slots 0 and up: they lie in one of two carry
    row sets, by the tile's parity, zeroed at the start of a row. The tile
    that ends with the row stores the last column from its carry."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    plan = launch_plan("conv3x3_roll", torch.bfloat16, b, h, wd, c, o)
    w = w.to(x.dtype)
    wt = w.permute(0, 1, 3, 2).contiguous().float()
    out = torch.full((b, h, wd, o), float("nan"), dtype=x.dtype)
    (sr, sc), ks, n = plan.tile, plan.kc, plan.oc
    n_strips, tx = -(-h // sr), -(-wd // sc)
    items = b * n_strips
    walkers = max(1, min(items, n_sms // plan.n_oc))

    def row_a(q, par):
        return 64 + 2 * (par ^ 1) + q if q < 2 else (
            q if q < 64 else 64 + 2 * par + q - 64)

    def row_b(q, par):
        return 64 + (par ^ 1) if q < 1 else (q if q < 64 else 64 + par)

    for i in range(plan.n_oc * walkers):
        o0 = (i % plan.n_oc) * n
        # The panels outlive the tiles, as the kernel's shared memory does.
        pa = torch.full((2, 68, n), float("nan"))
        pb = torch.full((2, 66, n), float("nan"))
        for item in range(i // plan.n_oc, items, walkers):
            bi, sy = item // n_strips, item % n_strips
            for xt in range(tx):
                par, x0 = xt & 1, xt * sc
                p = torch.zeros((2, 3, 64, n))  # [wg, j, pixel, n]
                for cc in range(plan.n_cc):
                    rows = _zero_filled_box(x[bi], sy * sr - 1, x0, sr + 2,
                                            sc, cc * ks).float()
                    wk = wt[:, :, o0 : o0 + n, cc * ks : (cc + 1) * ks]
                    for wg in range(2):
                        for dy in range(3):
                            for j in range(3):
                                p[wg, j] += rows[wg + dy, :, :ks] @ wk[dy, j].T
                for wg in range(2):
                    y = sy * sr + wg
                    if xt == 0:
                        pa[wg, row_a(0, par)] = 0.0
                        pa[wg, row_a(1, par)] = 0.0
                        pb[wg, row_b(0, par)] = 0.0
                    for q in range(64):
                        pa[wg, row_a(q + 2, par)] = p[wg, 0, q]
                        pb[wg, row_b(q + 1, par)] = p[wg, 1, q]
                    if y >= h:
                        continue
                    for q in range(64):
                        xo = x0 - 1 + q
                        if 0 <= xo < wd:
                            out[bi, y, xo, o0 : o0 + n] = (
                                pa[wg, row_a(q, par)] + pb[wg, row_b(q, par)]
                                + p[wg, 2, q]).to(x.dtype)
                    if x0 + sc == wd:
                        out[bi, y, wd - 1, o0 : o0 + n] = (
                            pa[wg, row_a(64, par)] + pb[wg, row_b(64, par)]
                        ).to(x.dtype)
    return out


def _bind(lib) -> None:
    for fns in (_FWD_FNS, _ROLL_FNS):
        for name in fns.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int


def tf32_weights(w: torch.Tensor) -> torch.Tensor:
    """The f32 kernels' weight operand from w [3, 3, C, O]: each tap as
    [O, C'], C' = C rounded up to 32 with zeros, each 32-channel chunk in
    the column order of the kernels' A fragments (``csrc/conv3x3.cu:
    load_a``): the channel at position 8 s + 4 h + t (t < 4, h < 2, s < KS)
    is 2 KS t + 2 s + h, with KS = 4 k-steps, or 2 in a last chunk of 16
    channels. One copy (two with such a chunk): it runs at every launch."""
    c, o = w.shape[2], w.shape[3]
    cp = _round_up(c, F32_CHUNK)
    full = c - c % F32_CHUNK
    out = torch.empty((3, 3, o, cp), dtype=w.dtype, device=w.device)
    # [.., q, t, s, h, o] -> [.., o, q, s, h, t]
    q = full // F32_CHUNK
    out[..., :full].view(3, 3, o, q, 4, 2, 4).copy_(
        w[:, :, :full].view(3, 3, q, 4, 4, 2, o).permute(
            0, 1, 6, 2, 4, 5, 3))
    if full < c:  # a last chunk of 16 channels, KS = 2
        out[..., full : full + 16].view(3, 3, o, 2, 2, 4).copy_(
            w[:, :, full:].reshape(3, 3, 4, 2, 2, o).permute(0, 1, 5, 3, 4, 2))
        out[..., full + 16 :] = 0
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, kernel: str) -> torch.Tensor:
    """Check the operands and launch one of the two forward kernels."""
    fns = _FWD_FNS if kernel == "conv3x3" else _ROLL_FNS
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{kernel}: unsupported devices {x.device}, "
                         f"{w.device}")
    if x.dtype not in fns:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"{kernel}: need x [B, H, W, C] and w [3, 3, C, O]; "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, c = x.shape
    o = w.shape[-1]
    plan = launch_plan(kernel, x.dtype, b, h, wd, c, o)
    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        # The kernel's B operand: each tap as [O, C], cast in the same pass.
        wk = torch.empty((3, 3, o, c), dtype=x.dtype, device=x.device)
        wk.copy_(w.detach().permute(0, 1, 3, 2))
    else:
        wk = tf32_weights(w.detach().to(x.dtype))
    out = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    if x.data_ptr() % 16 or wk.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{kernel}: operands must be 16-byte aligned")
    lib = _build.library("conv3x3", _bind)
    with torch.cuda.device(x.device):
        rc = getattr(lib, fns[x.dtype])(
            x.data_ptr(), wk.data_ptr(), out.data_ptr(), b, h, wd, c, o,
            plan.kc, plan.oc, int(plan.stationary), plan.stages,
            plan.smem_bytes, _build.stream_ptr(x),
        )
    _build.check(rc, kernel)
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input-stationary forward without autograd: the plain version on
    the CPU, the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    out = _launch(x, w, "conv3x3")
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
    out = _launch(x, w, "conv3x3_roll")
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
