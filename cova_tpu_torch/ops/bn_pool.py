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

Both kernels walk tiles of the map staged in shared memory with a halo.
The forward takes each tile's maxima in three stages (columns, rows, phase
groups); ``fwd_plan`` is its launch plan and
``bn_relu_pool_s2d_tiled_reference`` a plain version that follows its
schedule. The backward finds each output's winner once and lets every input
gather its contributions; ``bwd_plan`` is its launch plan and
``bn_relu_pool_s2d_backward_tiled_reference`` a plain version that follows
its schedule. So the CPU tests reach both kernels' index arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_stem import stem_pool_s2d

_FNS = {torch.float32: "bn_relu_pool_fwd_f32",
        torch.bfloat16: "bn_relu_pool_fwd_bf16"}
_BWD_FNS = {torch.float32: "bn_relu_pool_bwd_f32",
            torch.bfloat16: "bn_relu_pool_bwd_bf16"}
# The backward kernel's schedule (``csrc/bn_pool.cu``): s2d blocks per tile
# by dtype (BwdTile), threads per block at most, blocks it aims to keep on an
# SM; the H100's shared memory per SM and per block (227 KB), and what the
# runtime keeps of it per block.
BWD_TILES = {torch.bfloat16: (8, 16), torch.float32: (8, 8)}
# The forward kernel's schedule: s2d blocks per tile (kFwdU x kFwdV), threads
# per block at most, stages of tiles in flight, blocks it aims to keep on an
# SM, and the bytes of one group's channel chunk it aims for.
FWD_TILE = (8, 16)
FWD_MAX_THREADS = 256
FWD_STAGES = 2
FWD_BLOCKS_PER_SM = 1
FWD_CHUNK_BYTES = 64
BWD_MAX_THREADS = 256
BWD_BLOCKS_PER_SM = 3
SMEM_PER_SM = 233472
SMEM_MAX = 232448
SMEM_RESERVED = 1024
N_SMS = 132
_VEC_BYTES = 16


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


class FwdPlan(NamedTuple):
    """How the forward kernel (``csrc/bn_pool.cu``) runs one shape."""

    vec: int  # channels per access: 16 bytes' worth, else one pair
    fc: int  # channels f per chunk (of each of the four groups)
    n_chunks: int  # O // fc; block x keeps chunk x % n_chunks
    tile: Tuple[int, int]  # s2d blocks per tile
    row_splits: int  # threads per output column of a tile
    threads: int  # fc // vec * tile[1] * row_splits
    stages: int  # tiles in flight per block (by TMA where vec is 16 bytes)
    smem_bytes: int  # dynamic shared memory per block
    n_tiles: int
    n_walkers: int  # blocks per chunk; each walks every n_walkers-th tile


def _fwd_stage_bytes(fc: int, itemsize: int) -> int:
    """One tile's ys with its halo row and column, [tile_u + 1 rows][4
    groups][tile_v + 1 columns][fc], rounded up to 128 bytes."""
    tu, tv = FWD_TILE
    return -(-(tu + 1) * 4 * (tv + 1) * fc * itemsize // 128) * 128


def fwd_plan(dtype: torch.dtype, b: int, u: int, v: int, o: int,
             aligned: bool = True, *, stages: int = FWD_STAGES,
             chunk_bytes: int = FWD_CHUNK_BYTES,
             blocks_per_sm: int = FWD_BLOCKS_PER_SM) -> FwdPlan:
    """The forward kernel's plan for ys [b, u, v, 4*o]; ``aligned``: ys and
    the output lie on 16-byte addresses. The channel chunk is the largest
    divisor of o (a multiple of the access width) of at most
    ``chunk_bytes``; a thread takes one output column of a tile and as many
    of its rows as the threads allow; the stages (``stages`` tiles of ys
    with their halos and their mbarriers) must leave room for
    ``blocks_per_sm`` blocks on an SM. Tiles come by TMA where a thread
    moves 16 bytes, else by cp.async. The defaults are the fastest of
    ``scripts/sweep_pool_plans.py``'s variants on the H100 (PERF.md).
    Raises for what the kernel does not take."""
    if dtype not in _FNS:
        raise TypeError(f"bn_relu_pool_s2d: unsupported dtype {dtype}")
    if o % 2 or o < 2 or o > 512:
        raise ValueError(f"bn_relu_pool_s2d: need an even O <= 512, got {o}")
    if not 2 <= stages <= 4:
        raise ValueError(f"bn_relu_pool_s2d: 2 to 4 stages, got {stages}")
    isz = torch.empty((), dtype=dtype).element_size()
    full = _VEC_BYTES // isz
    vec = full if aligned and o % full == 0 else 2
    tu, tv = FWD_TILE
    fc = max(f for f in range(vec, o + 1, vec)
             if o % f == 0 and (f == vec or f * isz <= chunk_bytes))
    lanes = fc // vec
    rs = max(r for r in (1, 2, 4, 8)
             if tu % r == 0 and lanes * tv * r <= FWD_MAX_THREADS)
    smem = 128 + stages * (_fwd_stage_bytes(fc, isz) + 8)
    if blocks_per_sm * (smem + SMEM_RESERVED) > SMEM_PER_SM:
        raise ValueError(f"bn_relu_pool_s2d: {stages} stages of {fc} "
                         f"channels leave no room for {blocks_per_sm} "
                         f"blocks on an SM")
    n_tiles = b * -(-u // tu) * -(-v // tv)
    if n_tiles >= 2 ** 31 or (tu + 1) * v * 4 * o >= 2 ** 31:
        raise ValueError("bn_relu_pool_s2d: the map is too large for the "
                         "kernel's 32-bit tile offsets")
    n_chunks = o // fc
    n_walkers = max(1, min(n_tiles, -(-N_SMS * blocks_per_sm // n_chunks)))
    return FwdPlan(vec, fc, n_chunks, FWD_TILE, rs, lanes * tv * rs, stages,
                   smem, n_tiles, n_walkers)


def bn_relu_pool_s2d_tiled_reference(
    ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    plan: Optional[FwdPlan] = None,
) -> torch.Tensor:
    """Plain version that follows the forward kernel's schedule
    (``fwd_plan``): each walker's tiles in order, per channel chunk; per
    tile, ys with its halo row above and column to the left as the stage
    holds it (zero outside the map, as TMA fills it), the affine of every
    staged element (unfused multiply, then add, in f32), -inf in place of
    the halo row of the map's first tile row and of the halo column of its
    first tile column; then the column stage (ex = 1 groups), the row stage
    (ey = 1 groups), the max over the four groups, ReLU and one rounding.
    Equal to ``bn_relu_pool_s2d_reference`` bit for bit. On the CPU."""
    b_, u_, v_, c4 = ys.shape
    o = c4 // 4
    if plan is None:
        plan = fwd_plan(ys.dtype, b_, u_, v_, o)
    tu, tv = plan.tile
    nu, nv = -(-u_ // tu), -(-v_ // tv)
    x_all = ys.float().reshape(b_, u_, v_, 4, o)
    sc, sh = scale.float(), shift.float()
    out = torch.empty((b_, u_, v_, o), dtype=ys.dtype)
    ninf = float("-inf")
    for chunk in range(plan.n_chunks):
        f = slice(chunk * plan.fc, (chunk + 1) * plan.fc)
        for walker in range(plan.n_walkers):
            for t in range(walker, plan.n_tiles, plan.n_walkers):
                b, rest = divmod(t, nu * nv)
                u0, v0 = (rest // nv) * tu, (rest % nv) * tv
                # The stage: rows u0-1 .. u0+tu-1, columns v0-1 .. v0+tv-1.
                stage = torch.zeros(tu + 1, tv + 1, 4, plan.fc)
                r0, c0 = max(u0 - 1, 0), max(v0 - 1, 0)
                r1, c1 = min(u0 + tu, u_), min(v0 + tv, v_)
                stage[r0 - u0 + 1 : r1 - u0 + 1, c0 - v0 + 1 : c1 - v0 + 1] = (
                    x_all[b, r0:r1, c0:c1, :, f])
                z = stage * sc[f] + sh[f]
                if u0 == 0:
                    z[0] = ninf
                if v0 == 0:
                    z[:, 0] = ninf
                # Column stage, ex = 1 groups: column j-1 against j.
                zc = z[:, 1:].clone()
                zc[:, :, 1::2] = torch.maximum(z[:, :-1, 1::2], z[:, 1:, 1::2])
                # Row stage, ey = 1 groups: row i-1 against i.
                zr = zc[1:].clone()
                zr[:, :, 2:] = torch.maximum(zc[:-1, :, 2:], zc[1:, :, 2:])
                m = zr.amax(2)
                nu_o, nv_o = min(tu, u_ - u0), min(tv, v_ - v0)
                out[b, u0 : u0 + nu_o, v0 : v0 + nv_o, f] = (
                    m[:nu_o, :nv_o].clamp_min(0).to(ys.dtype))
    return out


class BwdPlan(NamedTuple):
    """How the backward kernel (``csrc/bn_pool.cu``) runs one shape."""

    vec: int  # channels per access: 16 bytes' worth, else one pair
    fc: int  # channels f per chunk (of each of the four groups)
    n_chunks: int  # O // fc; block x keeps chunk x % n_chunks
    tile: Tuple[int, int]  # s2d blocks per tile
    block: Tuple[int, int]  # threads: (4 * fc // vec, pixel slots)
    smem_bytes: int  # dynamic shared memory per block
    n_tiles: int
    n_walkers: int  # blocks per chunk; each walks every n_walkers-th tile


def _bwd_smem(fc: int, vec: int, itemsize: int, threads: int,
              tile: Tuple[int, int]) -> int:
    """Bytes of the layout of ``csrc/bn_pool.cu`` from a 128-byte boundary
    (128 bytes of slack before it): two tile buffers (ys with its halo, g
    of the tile's outputs, each rounded up to 128 bytes), the winner codes
    (rounded up to 16), the chunk's scale and shift, two mbarriers; and the
    sums' reduction, which reuses the same memory at the end."""
    tu, tv = tile
    seg = fc * itemsize

    def up(n, k):
        return -(-n // k) * k

    stage = (up((tu + 2) * (tv + 2) * 4 * seg, 128)
             + up((tu + 1) * (tv + 1) * seg, 128))
    codes = up((tu + 1) * (tv + 1) * fc, 16)
    return 128 + max(2 * stage + codes + 2 * fc * 4 + 16,
                     threads * 2 * vec * 4)


def bwd_plan(dtype: torch.dtype, b: int, u: int, v: int, o: int,
             aligned: bool = True) -> BwdPlan:
    """The backward kernel's plan for ys [b, u, v, 4*o]; ``aligned``: ys, g
    and dys lie on 16-byte addresses. The channel chunk is the largest
    divisor of o (a multiple of the access width) whose tiles leave room for
    BWD_BLOCKS_PER_SM blocks on an SM. Raises for what the kernel does not
    take."""
    if dtype not in _BWD_FNS:
        raise TypeError(f"bn_relu_pool_s2d_backward: unsupported dtype {dtype}")
    if o % 2 or o < 2 or o > 512:
        raise ValueError(f"bn_relu_pool_s2d_backward: need an even O <= 512, "
                         f"got {o}")
    isz = torch.empty((), dtype=dtype).element_size()
    full = _VEC_BYTES // isz
    vec = full if aligned and o % full == 0 else 2
    tile = BWD_TILES[dtype]
    cands = [fc for fc in range(vec, o + 1, vec)
             if o % fc == 0 and 4 * fc // vec <= BWD_MAX_THREADS]

    def smem(fc):
        lanes = 4 * fc // vec
        return _bwd_smem(fc, vec, isz, lanes * (BWD_MAX_THREADS // lanes),
                         tile)

    room = SMEM_PER_SM // BWD_BLOCKS_PER_SM - SMEM_RESERVED
    fc = max([fc for fc in cands if smem(fc) <= room] or [min(cands)])
    lanes = 4 * fc // vec
    block = (lanes, BWD_MAX_THREADS // lanes)
    n_tiles = b * -(-u // tile[0]) * -(-v // tile[1])
    n_chunks = o // fc
    per_sm = max(1, min(BWD_BLOCKS_PER_SM,
                        SMEM_PER_SM // (smem(fc) + SMEM_RESERVED)))
    n_walkers = max(1, min(n_tiles, -(-N_SMS * per_sm // n_chunks)))
    return BwdPlan(vec, fc, n_chunks, tile, block, smem(fc), n_tiles,
                   n_walkers)


def _winner_codes(z: torch.Tensor, up: torch.Tensor,
                  left: torch.Tensor) -> torch.Tensor:
    """The backward kernel's winner codes of the outputs of one tile.

    z: the affine [R + 1, S + 1, 4, O] of the tile's ys with its halo row
    above and column to the left (f32); up, left: [R, 1] and [1, S] bool,
    whether row i-1 (column j-1) of output (i, j) lies in the map. Returns
    uint8 [R, S, O]: 0 where no gradient flows, else 1 + 4 * group + 2 *
    (row i-1 won) + (column j-1 won)."""
    ninf = torch.tensor(float("-inf"))
    up, left = up[..., None], left[..., None]
    here, west = z[1:, 1:], z[1:, :-1]
    north, nw = z[:-1, 1:], z[:-1, :-1]
    best = torch.full(here.shape[:2] + here.shape[3:], float("-inf"))
    code = torch.zeros(best.shape, dtype=torch.uint8)

    def take(zr, w):
        nonlocal best, code
        win = zr > best
        best = torch.where(win, zr, best)
        code = torch.where(win, w.to(torch.uint8), code)

    take(here[:, :, 0], torch.tensor(1))
    # group 1: column j-1 against j, j-1 wins ties.
    zl = torch.where(left, west[:, :, 1], ninf)
    cs = zl >= here[:, :, 1]
    take(torch.where(cs, zl, here[:, :, 1]), 5 + cs.int())
    # group 2: row i-1 against i, i-1 wins ties.
    zu = torch.where(up, north[:, :, 2], ninf)
    rs = zu >= here[:, :, 2]
    take(torch.where(rs, zu, here[:, :, 2]), 9 + 2 * rs.int())
    # group 3: the column stage on rows i and i-1, then the row stage.
    zl = torch.where(left, west[:, :, 3], ninf)
    ci = zl >= here[:, :, 3]
    zi = torch.where(ci, zl, here[:, :, 3])
    zul = torch.where(left, nw[:, :, 3], ninf)
    cu = up & (zul >= north[:, :, 3])
    zu = torch.where(up, torch.where(cu, zul, north[:, :, 3]), ninf)
    rs = zu >= zi
    cs = torch.where(rs, cu, ci)
    take(torch.where(rs, zu, zi), 13 + 2 * rs.int() + cs.int())
    return torch.where(best > 0, code, torch.zeros_like(code))


def bn_relu_pool_s2d_backward_tiled_reference(
    ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
    g: torch.Tensor,
):
    """Plain version that follows the backward kernel's schedule
    (``bwd_plan``): each walker's tiles in order; per tile, the winner codes
    of its outputs and of its extra row and column from ys with its halo
    (``_winner_codes``), then each input's gather of the at most four
    contributions in the plain version's order; the d(scale)/d(shift) sums
    per walker, then over the walkers. dys equals
    ``bn_relu_pool_s2d_backward_reference``'s bit for bit; the sums differ
    from its only by the order of f32 additions. On the CPU."""
    b_, u_, v_, c4 = ys.shape
    o = c4 // 4
    plan = bwd_plan(ys.dtype, b_, u_, v_, o)
    tu, tv = plan.tile
    nu, nv = -(-u_ // tu), -(-v_ // tv)
    sc, sh = scale.float(), shift.float()
    x_all = ys.float().reshape(b_, u_, v_, 4, o)
    gf = g.to(ys.dtype).float()
    dys = torch.empty_like(ys)
    rows = []
    for walker in range(plan.n_walkers):
        dsc = torch.zeros(4, o)
        dsh = torch.zeros(4, o)
        for t in range(walker, plan.n_tiles, plan.n_walkers):
            b, rest = divmod(t, nu * nv)
            u0, v0 = (rest // nv) * tu, (rest % nv) * tv
            # ys rows u0-1 .. u0+tu, columns v0-1 .. v0+tv; the affine of the
            # taps that lie in the map, -inf padding above and to the left.
            z = torch.full((tu + 2, tv + 2, 4, o), float("-inf"))
            r0, c0 = max(u0 - 1, 0), max(v0 - 1, 0)
            r1, c1 = min(u0 + tu + 1, u_), min(v0 + tv + 1, v_)
            z[r0 - u0 + 1 : r1 - u0 + 1, c0 - v0 + 1 : c1 - v0 + 1] = (
                x_all[b, r0:r1, c0:c1] * sc + sh)
            i = torch.arange(u0, u0 + tu + 1)[:, None]
            j = torch.arange(v0, v0 + tv + 1)[None, :]
            code = _winner_codes(z[: tu + 2, : tv + 2], i > 0, j > 0)
            code[(i >= u_).expand(-1, tv + 1)] = 0
            code[(j >= v_).expand(tu + 1, -1)] = 0
            gt = torch.zeros(tu + 1, tv + 1, o)
            ru, cv_ = min(tu + 1, u_ - u0), min(tv + 1, v_ - v0)
            gt[:ru, :cv_] = gf[b, u0 : u0 + ru, v0 : v0 + cv_]
            # Inputs (u0 + a, v0 + c): outputs (a, c), (a+1, c), (a, c+1),
            # (a+1, c+1) of the tile, in that order.
            nu_in, nv_in = min(tu, u_ - u0), min(tv, v_ - v0)
            for grp in range(4):
                want = 1 + 4 * grp

                def part(da, dc, inc):
                    cd = code[da : da + nu_in, dc : dc + nv_in]
                    gg = gt[da : da + nu_in, dc : dc + nv_in]
                    return torch.where(cd == want + inc, gg, 0.0)

                a0 = (0.0 + part(0, 0, 0)) + part(1, 0, 2)
                a1 = (0.0 + part(0, 1, 1)) + part(1, 1, 3)
                d = a0 + a1
                x = x_all[b, u0 : u0 + nu_in, v0 : v0 + nv_in, grp]
                dys[b, u0 : u0 + nu_in, v0 : v0 + nv_in,
                    grp * o : (grp + 1) * o] = (d * sc).to(ys.dtype)
                dsc[grp] += (d * x).sum((0, 1))
                dsh[grp] += d.sum((0, 1))
        rows.append(torch.stack([dsc.reshape(-1), dsh.reshape(-1)]))
    sums = torch.stack(rows).sum(0).reshape(2, 4, o).sum(1)
    return dys, sums[0], sums[1]


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    for name in _BWD_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int


def _forward(ys: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             plan: Optional[FwdPlan] = None) -> torch.Tensor:
    """The forward without autograd: the plain version on the CPU, the
    kernel on a CUDA tensor (with ``plan``, else ``fwd_plan``'s)."""
    if ys.device.type == "cpu":
        return bn_relu_pool_s2d_reference(ys, scale, shift)
    o = _check(ys, scale, shift, "bn_relu_pool_s2d", _FNS)
    b, u, v, _ = ys.shape
    scale = scale.detach().to(torch.float32).contiguous()
    shift = shift.detach().to(torch.float32).contiguous()
    out = torch.empty((b, u, v, o), dtype=ys.dtype, device=ys.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = fwd_plan(ys.dtype, b, u, v, o,
                        aligned=ys.data_ptr() % _VEC_BYTES == 0)
    lib = _build.library("bn_pool", _bind)
    with torch.cuda.device(ys.device):
        rc = getattr(lib, _FNS[ys.dtype])(
            ys.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, u, v, o, plan.vec, plan.fc, plan.row_splits,
            plan.stages, plan.n_walkers, plan.smem_bytes,
            _build.stream_ptr(ys),
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
    if (BWD_TILES[ys.dtype][0] + 2) * v * c4 >= 2 ** 31:
        raise ValueError("bn_relu_pool_s2d_backward: a tile's rows must "
                         "span fewer than 2^31 elements")
    scale = scale.detach().to(torch.float32).contiguous()
    shift = shift.detach().to(torch.float32).contiguous()
    g = g.detach().to(ys.dtype).contiguous()
    dys = torch.empty_like(ys)
    plan = bwd_plan(ys.dtype, b, u, v, o, aligned=all(
        t.data_ptr() % _VEC_BYTES == 0 for t in (ys, g, dys)))
    partial = torch.empty((plan.n_walkers, 2, c4), dtype=torch.float32,
                          device=ys.device)
    lib = _build.library("bn_pool", _bind)
    with torch.cuda.device(ys.device):
        rc = getattr(lib, _BWD_FNS[ys.dtype])(
            ys.data_ptr(), scale.data_ptr(), shift.data_ptr(), g.data_ptr(),
            dys.data_ptr(), partial.data_ptr(), b, u, v, o, plan.vec,
            plan.fc, *plan.tile, plan.n_walkers, plan.block[1],
            plan.smem_bytes, _build.stream_ptr(ys),
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
