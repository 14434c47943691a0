"""RoI max-pooling over an NHWC feature map, forward and backward: the CUDA
kernels of ``csrc/roi_pool.cu`` and their plain PyTorch versions.

Counterpart of ``cova_tpu/ops/roi_pool.py`` (the bin rules) and
``cova_tpu/ops/roi_pool_pallas.py`` (the kernels and their ``custom_vjp``).
Semantics are those of ``torchvision.ops.roi_pool``:

  * box coords are scaled by ``spatial_scale`` and quantized with
    round-half-away-from-zero (C ``roundf``, negative coords included);
  * roi width/height use the inclusive-end convention ``end - start + 1``,
    clamped to >= 1;
  * bin bounds are ``floor(i * roi/out) .. ceil((i+1) * roi/out)`` offset by
    the roi start and clipped to the map, in exact integer arithmetic;
  * empty bins give 0, and so do masked (padding) boxes.

The backward adds each bin's cotangent to every pixel of the bin whose value
equals the pooled max: every tied maximum gets the full cotangent, as the
Pallas kernel does (autodiff of a max would split it). Boxes get no
gradient.

``roi_pool`` is differentiable in ``fm``: when grad is enabled and ``fm``
requires it, it runs as an autograd function whose backward is
``roi_pool_backward``. On a CUDA tensor each wrapper launches its kernel (or
raises); on a CPU tensor it runs the plain version. Kernel and plain version
agree bit for bit, forward (a max selects one of its inputs) and backward
(both add a pixel's contributions in f32 in the same order, box by box and
bin by bin). ``roi_pool_plain`` is the same autograd function over the plain
versions, on any device.

Both kernels compute the bin bounds from the boxes with one rule in CUDA:
the forward kernel for its own bins, and the backward's launch starts with
a bounds kernel that writes ``roi_bounds``'s layout (``roi_pool_bounds``
runs it alone), so forward and backward agree on every bin. The forward
kernel builds a max pyramid over 8-row chunks of the map and reads each
bin's interior chunks from it and only its edge rows from the map;
``roi_pool_plan`` is its launch plan and ``roi_pool_pyramid_reference`` a
plain version that follows its schedule. The backward kernel takes tiles of
the map, lists the (box, bin) pairs that meet each tile in shared memory,
stages their pooled and g rows there and gathers; ``roi_bwd_plan`` is its
launch plan and ``roi_pool_backward_tiled_reference`` a plain version that
follows its schedule. So the CPU tests reach both kernels' index
arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_FNS = {torch.float32: "roi_pool_fwd_f32",
        torch.bfloat16: "roi_pool_fwd_bf16"}
_BWD_FNS = {torch.float32: "roi_pool_bwd_f32",
            torch.bfloat16: "roi_pool_bwd_bf16"}
_BOUNDS_FN = "roi_pool_bounds"
# The backward kernel keeps a tile's list of boxes in shared memory.
_BWD_MAX_BOXES = 8192
# The backward kernel's schedule (``csrc/roi_pool.cu``): the tile's side
# (kBwdTile; a thread takes one row of it and one pair of channels), channel
# pairs per pass at most, and the defaults of ``roi_bwd_plan``: pair list
# capacity, stage chunk, blocks per SM.
ROI_BWD_TILE = 8
ROI_BWD_LANES = 32
ROI_BWD_CAP = 512
ROI_BWD_CHUNK = 32
ROI_BWD_BLOCKS_PER_SM = 4
_SMEM_PER_SM = 233472
_SMEM_MAX = 232448
_N_SMS = 132
# The forward kernel's schedule (``csrc/roi_pool.cu``: kChunk, kBinThreads).
ROI_CHUNK = 8
ROI_BIN_THREADS = 128
_VEC_BYTES = 16


def _quantize(v: torch.Tensor, scale: float) -> torch.Tensor:
    """Round half away from zero (``roundf``), as int32."""
    vs = v * scale
    half = torch.where(vs >= 0, 0.5, -0.5).to(vs.dtype)
    return torch.trunc(vs + half).to(torch.int32)


def _bin_bounds(start: torch.Tensor, roi_len: torch.Tensor, out_size: int,
                limit: int):
    """Start/end map rows (cols) of each output bin, [..., out_size] int32,
    clipped to [0, limit]; ``roi_len`` >= 1."""
    i = torch.arange(out_size, dtype=torch.int32, device=start.device)
    rl = roi_len[..., None]
    s = start[..., None]
    lo = torch.div(i * rl, out_size, rounding_mode="floor") + s
    hi = torch.div((i + 1) * rl + out_size - 1, out_size,
                   rounding_mode="floor") + s
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_bounds(boxes: torch.Tensor, box_mask: Optional[torch.Tensor],
               spatial_scale: float, out_h: int, out_w: int, h: int,
               w: int) -> torch.Tensor:
    """Per-box bin bounds, int32 [B, P, 2*out_h + 2*out_w] laid out as
    ylo[out_h], yhi[out_h], xlo[out_w], xhi[out_w]. A masked box gets
    all-zero bounds, so every one of its bins is empty."""
    boxes = boxes.to(torch.float32)
    x1, y1, x2, y2 = (_quantize(boxes[..., k], spatial_scale)
                      for k in range(4))
    roi_w = torch.clamp(x2 - x1 + 1, min=1)
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    ylo, yhi = _bin_bounds(y1, roi_h, out_h, h)
    xlo, xhi = _bin_bounds(x1, roi_w, out_w, w)
    packed = torch.cat([ylo, yhi, xlo, xhi], dim=-1)
    if box_mask is not None:
        packed = packed * box_mask[..., None].to(torch.int32)
    return packed.contiguous()


def roi_pool_reference(
    fm: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: Optional[torch.Tensor],
    spatial_scale: float,
    out_h: int = 3,
    out_w: int = 3,
) -> torch.Tensor:
    """Plain version: one slice-and-max per bin.

    fm: [B, H, W, C]; boxes: [B, P, 4] x1y1x2y2 in image coords; box_mask:
    [B, P] bool or None. Returns [B, P, out_h, out_w, C] in fm.dtype.
    """
    b_, h, w, c = fm.shape
    p_ = boxes.shape[1]
    bounds = roi_bounds(boxes, box_mask, spatial_scale, out_h, out_w, h, w)
    out = fm.new_zeros((b_, p_, out_h, out_w, c))
    for b, page in enumerate(bounds.tolist()):
        for p, bd in enumerate(page):
            ylo, yhi = bd[:out_h], bd[out_h : 2 * out_h]
            xlo, xhi = bd[2 * out_h : 2 * out_h + out_w], bd[2 * out_h + out_w :]
            for i in range(out_h):
                if yhi[i] <= ylo[i]:
                    continue
                rows = fm[b, ylo[i] : yhi[i]].amax(dim=0)  # [W, C]
                for j in range(out_w):
                    if xhi[j] > xlo[j]:
                        out[b, p, i, j] = rows[xlo[j] : xhi[j]].amax(dim=0)
    return out


def roi_pool_backward_reference(
    fm: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: Optional[torch.Tensor],
    pooled: torch.Tensor,
    g: torch.Tensor,
    spatial_scale: float,
    out_h: int = 3,
    out_w: int = 3,
) -> torch.Tensor:
    """Plain version of the backward: one slice-compare-add per bin, box by
    box and bin by bin, into an f32 map.

    fm: [B, H, W, C]; pooled: the forward's [B, P, out_h, out_w, C]; g: its
    cotangent (cast to fm.dtype, as the JAX VJP does). Returns dfm in
    fm.dtype: ``dfm[b, y, x, c] = sum of g[b, p, i, j, c]`` over the bins
    holding (y, x) where ``fm[b, y, x, c] == pooled[b, p, i, j, c]``.
    """
    h, w = fm.shape[1:3]
    bounds = roi_bounds(boxes, box_mask, spatial_scale, out_h, out_w, h, w)
    g = g.to(fm.dtype).float()
    pooled = pooled.float()
    dfm = torch.zeros(fm.shape, dtype=torch.float32, device=fm.device)
    for b, page in enumerate(bounds.tolist()):
        for p, bd in enumerate(page):
            ylo, yhi = bd[:out_h], bd[out_h : 2 * out_h]
            xlo, xhi = bd[2 * out_h : 2 * out_h + out_w], bd[2 * out_h + out_w :]
            for i in range(out_h):
                for j in range(out_w):
                    if yhi[i] <= ylo[i] or xhi[j] <= xlo[j]:
                        continue
                    win = (b, slice(ylo[i], yhi[i]), slice(xlo[j], xhi[j]))
                    hit = fm[win].float() == pooled[b, p, i, j]
                    dfm[win] += torch.where(hit, g[b, p, i, j], 0.0)
    return dfm.to(fm.dtype)


class RoiPoolPlan(NamedTuple):
    """How the forward kernel (``csrc/roi_pool.cu``) runs one shape."""

    vec: int  # channels per access: 16 bytes' worth, else one pair
    chunk: int  # pyramid rows per chunk
    n_chunks: int  # ceil(H / chunk); the last chunk may be partial
    pyramid_shape: Tuple[int, int, int, int]  # [B, n_chunks, W, C]
    threads: int  # threads of one bin's block
    vecs_per_pass: int  # channel vectors one pass of the block covers
    slots: int  # pixel slots: the block reads `slots` columns per step
    n_items: int  # blocks: one per (image, box, bin)
    smem_bytes: int  # static shared memory of the bins kernel


def roi_pool_plan(dtype: torch.dtype, b: int, p: int, h: int, w: int, c: int,
                  out_h: int, out_w: int, aligned: bool = True) -> RoiPoolPlan:
    """The forward kernel's plan for fm [b, h, w, c] and p boxes of out_h x
    out_w bins; ``aligned``: fm's address is a multiple of 16 bytes.
    Raises for what the kernel does not take."""
    if dtype not in _FNS:
        raise TypeError(f"roi_pool: unsupported dtype {dtype}")
    if c % 2 or c < 2 or out_h < 1 or out_w < 1 or out_h * out_w > 32:
        raise ValueError(f"roi_pool: need an even channel count and at most "
                         f"32 bins, got C={c}, {out_h}x{out_w}")
    isz = torch.empty((), dtype=dtype).element_size()
    full = _VEC_BYTES // isz
    vec = full if aligned and c % full == 0 else 2
    per_pass = min(c // vec, ROI_BIN_THREADS)
    n_chunks = -(-h // ROI_CHUNK)
    return RoiPoolPlan(vec, ROI_CHUNK, n_chunks, (b, n_chunks, w, c),
                       ROI_BIN_THREADS, per_pass, ROI_BIN_THREADS // per_pass,
                       b * p * out_h * out_w, ROI_BIN_THREADS * vec * isz)


def roi_pyramid(fm: torch.Tensor, chunk: int = ROI_CHUNK) -> torch.Tensor:
    """The forward kernel's first launch: the max of fm [B, H, W, C] over
    the rows [k * chunk, min(H, (k + 1) * chunk)), as [B, ceil(H / chunk),
    W, C]; the last chunk may be partial."""
    b, h, w, c = fm.shape
    full = h // chunk
    parts = [fm[:, : full * chunk].reshape(b, full, chunk, w, c).amax(2)]
    if h % chunk:
        parts.append(fm[:, full * chunk :].amax(1, keepdim=True))
    return torch.cat(parts, 1)


def bin_rows(ylo: int, yhi: int, h: int, chunk: int = ROI_CHUNK):
    """The forward kernel's split of a non-empty bin's rows [ylo, yhi) of a
    map of h rows: top edge rows of fm, a run of pyramid chunks that lie
    wholly inside the bin (the last, partial chunk counts where the bin
    reaches row h), bottom edge rows of fm; as three half-open ranges."""
    c0 = -(-ylo // chunk)
    c1 = -(-h // chunk) if yhi == h else yhi // chunk
    if c0 < c1:
        return (ylo, c0 * chunk), (c0, c1), (min(c1 * chunk, yhi), yhi)
    return (ylo, yhi), (c0, c0), (yhi, yhi)


def roi_pool_pyramid_reference(
    fm: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: Optional[torch.Tensor],
    spatial_scale: float,
    out_h: int = 3,
    out_w: int = 3,
) -> torch.Tensor:
    """Plain version that follows the forward kernel's schedule: the chunk
    pyramid, one work item per (image, box, bin) walked from the last image
    to the first, each bin's rows split by ``bin_rows`` and its columns over
    the block's pixel slots. Equal to ``roi_pool_reference`` bit for bit."""
    b_, h, w, c = fm.shape
    p_ = boxes.shape[1]
    plan = roi_pool_plan(fm.dtype, b_, p_, h, w, c, out_h, out_w)
    pyr = roi_pyramid(fm, plan.chunk)
    out = fm.new_zeros((b_, p_, out_h, out_w, c))
    bounds = roi_bounds(boxes, box_mask, spatial_scale, out_h, out_w, h,
                        w).tolist()
    bins = out_h * out_w
    for item in reversed(range(plan.n_items)):
        bp, bin_ = divmod(item, bins)
        b, p = divmod(bp, p_)
        i, j = divmod(bin_, out_w)
        bd = bounds[b][p]
        ylo, yhi = bd[i], bd[out_h + i]
        xlo, xhi = bd[2 * out_h + j], bd[2 * out_h + out_w + j]
        if yhi <= ylo or xhi <= xlo:
            continue
        (t0, t1), (c0, c1), (e0, e1) = bin_rows(ylo, yhi, h, plan.chunk)
        rows = torch.cat([fm[b, t0:t1], pyr[b, c0:c1], fm[b, e0:e1]])
        # Slot s reads the columns xlo + s, xlo + s + slots, ...
        n_step = -(-(xhi - xlo) // plan.slots)
        cols = rows.new_full((rows.shape[0], n_step * plan.slots, c),
                             float("-inf"))
        cols[:, : xhi - xlo] = rows[:, xlo:xhi]
        slot_max = cols.reshape(rows.shape[0], n_step, plan.slots, c).amax(
            (0, 1))
        out[b, p, i, j] = slot_max.amax(0)
    return out


class RoiBwdPlan(NamedTuple):
    """How the backward kernel (``csrc/roi_pool.cu``) runs one shape."""

    tile: Tuple[int, int]  # pixels per tile, (rows, columns)
    lanes: int  # channel pairs of one pass (a thread takes one)
    passes: int  # ceil(C / 2 / lanes)
    threads: int  # lanes x tile rows, rounded up to a warp
    cap: int  # pairs the list holds before it is walked
    chunk: int  # pairs whose pooled and g rows are staged at a time
    round: int  # candidates (box x bin) tested at a time
    copy16: bool  # stage copies of 16 bytes (else one pair of channels)
    blocks: int  # persistent blocks; each takes tiles from a counter
    smem_bytes: int  # dynamic shared memory per block
    n_tiles: int


def _roi_bwd_smem(lanes: int, pair_bytes: int, chunk: int, cap: int,
                  p: int) -> int:
    """Bytes of the kernel's layout (BwdSmem): two stage buffers of chunk x
    (pooled, g) rows of ``lanes`` pairs (rounded up to 16 bytes), the pair
    list's pixel maps and cells, the box list (each rounded up to 16), the
    warps' counts and the tile number."""

    def up16(n):
        return -(-n // 16) * 16

    return (2 * chunk * 2 * up16(lanes * pair_bytes) + cap * 8
            + up16(cap * 4) + up16(p * 4) + 9 * 4)


def roi_bwd_plan(dtype: torch.dtype, b: int, p: int, h: int, w: int, c: int,
                 out_h: int, out_w: int, aligned: bool = True, *,
                 cap: int = ROI_BWD_CAP, chunk: int = ROI_BWD_CHUNK,
                 round_: Optional[int] = None,
                 blocks_per_sm: int = ROI_BWD_BLOCKS_PER_SM) -> RoiBwdPlan:
    """The backward kernel's plan for fm [b, h, w, c] and p boxes of out_h
    x out_w bins; ``aligned``: fm, pooled, g and dfm lie on 16-byte
    addresses. Tiles of 8 x 8 pixels; a thread takes one row of a tile and
    one pair of channels; a pass covers at most ROI_BWD_LANES pairs. Candidates are
    tested a block's worth at a time (``round_``, at most ``cap``); the list
    is walked when another round might overflow it. Raises for what the
    kernel does not take."""
    if dtype not in _BWD_FNS:
        raise TypeError(f"roi_pool_backward: unsupported dtype {dtype}")
    if c % 2 or c < 2 or out_h < 1 or out_w < 1 or out_h * out_w > 32:
        raise ValueError(f"roi_pool_backward: need an even channel count "
                         f"and at most 32 bins, got C={c}, {out_h}x{out_w}")
    if p > _BWD_MAX_BOXES:
        raise ValueError(f"roi_pool_backward: at most {_BWD_MAX_BOXES} "
                         f"boxes per image, got {p}")
    isz = torch.empty((), dtype=dtype).element_size()
    ty = tx = ROI_BWD_TILE
    lanes = min(c // 2, ROI_BWD_LANES)
    threads = -(-lanes * ty // 32) * 32
    round_ = min(threads, cap) if round_ is None else round_
    if not 1 <= round_ <= min(threads, cap) or chunk < 1:
        raise ValueError(f"roi_pool_backward: round {round_}, cap {cap}, "
                         f"chunk {chunk}")
    copy16 = aligned and (2 * lanes * isz) % 16 == 0 and (c * isz) % 16 == 0
    smem = _roi_bwd_smem(lanes, 2 * isz, chunk, cap, p)
    if smem > _SMEM_MAX:
        raise ValueError(f"roi_pool_backward: {smem} bytes of shared memory")
    n_tiles = b * -(-h // ty) * -(-w // tx)
    if n_tiles >= 2 ** 31 or b * p * out_h * out_w >= 2 ** 31:
        raise ValueError("roi_pool_backward: too many tiles or bins")
    per_sm = max(1, min(blocks_per_sm, _SMEM_PER_SM // (smem + 1024)))
    blocks = max(1, min(n_tiles, _N_SMS * per_sm))
    return RoiBwdPlan((ty, tx), lanes, -(-(c // 2) // lanes), threads, cap,
                      chunk, round_, copy16, blocks, smem, n_tiles)


def _tile_lists(bd, y0: int, x0: int, ty: int, tx: int, out_h: int,
                out_w: int, plan: RoiBwdPlan):
    """The backward kernel's pair lists of one tile (``bd``: the image's
    bounds, a list of lists): the boxes whose outer range meets the tile in
    ascending order, their (box, bin) candidates in ascending (box, bin row,
    bin column) order tested ``plan.round`` at a time, the pairs that meet
    the tile kept as (box, bin row, bin column, rows, columns) with the
    bin's rows and columns clipped to the tile (tile coordinates); a new
    list starts where another round might overflow ``plan.cap``."""
    boxes = [p for p, r in enumerate(bd)
             if r[0] < r[2 * out_h - 1] and r[2 * out_h] < r[-1]
             and r[0] < y0 + ty and r[2 * out_h - 1] > y0
             and r[2 * out_h] < x0 + tx and r[-1] > x0]
    cands = [(p, i, j) for p in boxes for i in range(out_h)
             for j in range(out_w)]
    lists, cursor = [], 0
    while cursor < len(cands):
        lst = []
        while cursor < len(cands) and len(lst) + plan.round <= plan.cap:
            for p, i, j in cands[cursor : cursor + plan.round]:
                r = bd[p]
                ly0, ly1 = max(r[i], y0) - y0, min(r[out_h + i], y0 + ty) - y0
                lx0 = max(r[2 * out_h + j], x0) - x0
                lx1 = min(r[2 * out_h + out_w + j], x0 + tx) - x0
                if ly0 < ly1 and lx0 < lx1:
                    lst.append((p, i, j, (ly0, ly1), (lx0, lx1)))
            cursor += plan.round
        lists.append(lst)
    return lists


def roi_pool_backward_tiled_reference(
    fm: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: Optional[torch.Tensor],
    pooled: torch.Tensor,
    g: torch.Tensor,
    spatial_scale: float,
    out_h: int = 3,
    out_w: int = 3,
    plan: Optional[RoiBwdPlan] = None,
) -> torch.Tensor:
    """Plain version that follows the backward kernel's schedule
    (``roi_bwd_plan``, or ``plan``): tile by tile, per pass of channel
    pairs, the pair lists of ``_tile_lists`` walked in order in chunks of
    ``plan.chunk``, each listed bin's compare-and-add over its clipped
    rectangle, the sums in f32 from zero, one rounding per pixel. Equal to
    ``roi_pool_backward_reference`` bit for bit. On the CPU."""
    b_, h, w, c = fm.shape
    p_ = boxes.shape[1]
    if plan is None:
        plan = roi_bwd_plan(fm.dtype, b_, p_, h, w, c, out_h, out_w)
    ty, tx = plan.tile
    nty, ntx = -(-h // ty), -(-w // tx)
    bounds = roi_bounds(boxes, box_mask, spatial_scale, out_h, out_w, h,
                        w).tolist()
    f = fm.float()
    pf = pooled.to(fm.dtype).float()
    gf = g.to(fm.dtype).float()
    dfm = torch.empty_like(fm)
    for t in range(plan.n_tiles):
        b, rest = divmod(t, nty * ntx)
        y0, x0 = (rest // ntx) * ty, (rest % ntx) * tx
        acc = torch.zeros(min(ty, h - y0), min(tx, w - x0), c)
        lists = _tile_lists(bounds[b], y0, x0, ty, tx, out_h, out_w, plan)
        for pc in range(0, c // 2, plan.lanes):
            ch = slice(2 * pc, 2 * min(pc + plan.lanes, c // 2))
            for lst in lists:
                for k in range(0, len(lst), plan.chunk):
                    for p, i, j, (ly0, ly1), (lx0, lx1) in lst[k : k + plan.chunk]:
                        win = (slice(y0 + ly0, y0 + ly1),
                               slice(x0 + lx0, x0 + lx1), ch)
                        hit = f[b][win] == pf[b, p, i, j, ch]
                        acc[ly0:ly1, lx0:lx1, ch] += torch.where(
                            hit, gf[b, p, i, j, ch], 0.0)
        dfm[b, y0 : y0 + acc.shape[0], x0 : x0 + acc.shape[1]] = acc.to(
            fm.dtype)
    return dfm


def roi_bwd_tile_pairs(bounds: torch.Tensor, h: int, w: int, out_h: int,
                       out_w: int, tile: Tuple[int, int] = (ROI_BWD_TILE,
                                                            ROI_BWD_TILE)
                       ) -> torch.Tensor:
    """The number of (box, bin) pairs the backward kernel lists for each
    tile, [B, ceil(h / tile_h), ceil(w / tile_w)], from ``roi_bounds``'s
    table (on its device)."""
    ty, tx = tile
    bd = bounds.long()
    ylo, yhi, xlo, xhi = bd.split([out_h, out_h, out_w, out_w], -1)
    ys = torch.arange(0, h, ty, device=bd.device)
    xs = torch.arange(0, w, tx, device=bd.device)

    def meets(lo, hi, starts, size):  # [B, P, n] x tiles -> [B, P, n, T]
        lo, hi = lo[..., None], hi[..., None]
        return ((lo < hi) & (lo < starts + size) & (hi > starts)).float()

    my = meets(ylo, yhi, ys, ty)[:, :, :, None, :, None]
    mx = meets(xlo, xhi, xs, tx)[:, :, None, :, None, :]
    return (my * mx).sum((1, 2, 3)).round().long()


def _check(fm: torch.Tensor, boxes: torch.Tensor, what: str, fns,
           out_h: int, out_w: int) -> None:
    if fm.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {fm.device}")
    b, _, _, c = fm.shape
    if fm.dtype not in fns:
        raise TypeError(f"{what}: unsupported dtype {fm.dtype}")
    if c % 2 or out_h * out_w > 32:
        raise ValueError(f"{what}: need an even channel count and at most "
                         f"32 bins, got C={c}, {out_h}x{out_w}")
    if not fm.is_contiguous() or fm.data_ptr() % 8:
        raise ValueError(f"{what}: fm must be contiguous and aligned")
    if boxes.device != fm.device or boxes.dim() != 3 or boxes.shape[0] != b \
            or boxes.shape[2] != 4:
        raise ValueError(f"{what}: boxes must be [{b}, P, 4] on {fm.device}")


def _bind(lib) -> None:
    # (pointers, then B, P, H, W[, C], out_h, out_w, then the scale) and, in
    # the forward, vec and chunk, in the backward its plan; the stream last.
    ints, scale = [ctypes.c_int] * 7, [ctypes.c_float]
    sigs = {_BOUNDS_FN: [ctypes.c_void_p] * 3 + ints[:6] + scale}
    for name in _FNS.values():
        sigs[name] = ([ctypes.c_void_p] * 5 + ints + scale
                      + [ctypes.c_int] * 2)
    for name in _BWD_FNS.values():
        sigs[name] = ([ctypes.c_void_p] * 7 + ints + scale
                      + [ctypes.c_int] * 9)
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _box_args(boxes: torch.Tensor, box_mask: Optional[torch.Tensor],
              what: str):
    """The boxes as f32 and the mask as bool (or None), both contiguous."""
    b, p = boxes.shape[:2]
    mask = None
    if box_mask is not None:
        if box_mask.shape != (b, p) or box_mask.device != boxes.device:
            raise ValueError(f"{what}: box_mask must be [{b}, {p}] on "
                             f"{boxes.device}")
        mask = box_mask.to(torch.bool).contiguous()
    return boxes.to(torch.float32).contiguous(), mask


def _bounds_buffer(boxes: torch.Tensor, out_h: int,
                   out_w: int) -> torch.Tensor:
    """An int32 [B, P, 2*out_h + 2*out_w] buffer for the bounds kernel."""
    return torch.empty((*boxes.shape[:2], 2 * out_h + 2 * out_w),
                       dtype=torch.int32, device=boxes.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def roi_pool_bounds(boxes: torch.Tensor, box_mask: Optional[torch.Tensor],
                    spatial_scale: float, out_h: int, out_w: int, h: int,
                    w: int) -> torch.Tensor:
    """The bin bounds of every box, as ``roi_bounds`` lays them out: the
    bounds kernel on a CUDA tensor (one launch for all boxes; equal to
    ``roi_bounds`` bit for bit), ``roi_bounds`` itself on the CPU."""
    if boxes.device.type == "cpu":
        return roi_bounds(boxes, box_mask, spatial_scale, out_h, out_w, h, w)
    if boxes.device.type != "cuda" or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"roi_pool_bounds: boxes must be [B, P, 4] on a "
                         f"CUDA device, got {tuple(boxes.shape)} on "
                         f"{boxes.device}")
    boxes, mask = _box_args(boxes, box_mask, "roi_pool_bounds")
    bounds = _bounds_buffer(boxes, out_h, out_w)
    lib = _build.library("roi_pool", _bind)
    with torch.cuda.device(boxes.device):
        rc = getattr(lib, _BOUNDS_FN)(
            boxes.data_ptr(), _ptr(mask), bounds.data_ptr(), *boxes.shape[:2],
            h, w, out_h, out_w, float(spatial_scale),
            _build.stream_ptr(boxes),
        )
    _build.check(rc, "roi_pool_bounds")
    return bounds


def _forward(fm, boxes, box_mask, spatial_scale, out_h=3, out_w=3):
    """The forward without autograd: the plain version on the CPU, the
    kernel on a CUDA tensor."""
    if fm.device.type == "cpu":
        return roi_pool_reference(
            fm, boxes, box_mask, spatial_scale, out_h, out_w
        )
    _check(fm, boxes, "roi_pool", _FNS, out_h, out_w)
    b, h, w, c = fm.shape
    p = boxes.shape[1]
    out = torch.empty((b, p, out_h, out_w, c), dtype=fm.dtype,
                      device=fm.device)
    if out.numel() == 0:
        return out
    plan = roi_pool_plan(fm.dtype, b, p, h, w, c, out_h, out_w,
                         aligned=fm.data_ptr() % _VEC_BYTES == 0)
    boxes, mask = _box_args(boxes, box_mask, "roi_pool")
    pyr = torch.empty(plan.pyramid_shape, dtype=fm.dtype, device=fm.device)
    lib = _build.library("roi_pool", _bind)
    with torch.cuda.device(fm.device):
        rc = getattr(lib, _FNS[fm.dtype])(
            fm.data_ptr(), boxes.data_ptr(), _ptr(mask), pyr.data_ptr(),
            out.data_ptr(), b, p, h, w, c, out_h, out_w,
            float(spatial_scale), plan.vec, plan.chunk,
            _build.stream_ptr(fm),
        )
    _build.check(rc, "roi_pool")
    roi_pool.launches += 1
    return out


def roi_pool_backward(
    fm: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: Optional[torch.Tensor],
    pooled: torch.Tensor,
    g: torch.Tensor,
    spatial_scale: float,
    out_h: int = 3,
    out_w: int = 3,
    plan: Optional[RoiBwdPlan] = None,
) -> torch.Tensor:
    """Backward of ``roi_pool``: dfm [B, H, W, C] in fm.dtype for the
    cotangent ``g`` of ``pooled``. The kernel on a CUDA tensor (with
    ``plan``, else ``roi_bwd_plan``'s), the plain version on the CPU."""
    if fm.device.type == "cpu":
        return roi_pool_backward_reference(
            fm, boxes, box_mask, pooled, g, spatial_scale, out_h, out_w
        )
    _check(fm, boxes, "roi_pool_backward", _BWD_FNS, out_h, out_w)
    b, h, w, c = fm.shape
    p = boxes.shape[1]
    if pooled.shape != (b, p, out_h, out_w, c) or g.shape != pooled.shape:
        raise ValueError("roi_pool_backward: pooled and g must be "
                         f"[{b}, {p}, {out_h}, {out_w}, {c}]")
    boxes, mask = _box_args(boxes, box_mask, "roi_pool_backward")
    pooled = pooled.to(fm.dtype).contiguous()
    g = g.to(fm.dtype).contiguous()
    dfm = torch.empty_like(fm)
    if plan is None:
        plan = roi_bwd_plan(fm.dtype, b, p, h, w, c, out_h, out_w,
                            aligned=all(t.data_ptr() % _VEC_BYTES == 0
                                        for t in (fm, pooled, g)))
    # The bin bounds and, last, the kernel's tile counter.
    bounds = torch.empty(b * p * (2 * out_h + 2 * out_w) + 1,
                         dtype=torch.int32, device=fm.device)
    lib = _build.library("roi_pool", _bind)
    with torch.cuda.device(fm.device):
        rc = getattr(lib, _BWD_FNS[fm.dtype])(
            fm.data_ptr(), boxes.data_ptr(), _ptr(mask), bounds.data_ptr(),
            pooled.data_ptr(), g.data_ptr(), dfm.data_ptr(), b, p, h, w, c,
            out_h, out_w, float(spatial_scale), plan.tile[0], plan.lanes,
            plan.threads, plan.cap, plan.chunk, plan.round, int(plan.copy16),
            plan.blocks, plan.smem_bytes,
            _build.stream_ptr(fm),
        )
    _build.check(rc, "roi_pool_backward")
    roi_pool_backward.launches += 1
    return dfm


class _RoIPool(torch.autograd.Function):
    """Autograd over a (forward, backward) pair. Saves fm, the boxes, the
    mask and the pooled output, as the JAX VJP does; the boxes get no
    gradient (``roi_pool_pallas.py``'s VJP returns zeros for them)."""

    @staticmethod
    def forward(ctx, fm, boxes, box_mask, spatial_scale, out_h, out_w, fwd,
                bwd):
        pooled = fwd(fm, boxes, box_mask, spatial_scale, out_h, out_w)
        ctx.args = (spatial_scale, out_h, out_w)
        ctx.bwd = bwd
        ctx.save_for_backward(fm, boxes, box_mask, pooled)
        return pooled

    @staticmethod
    def backward(ctx, g):
        fm, boxes, box_mask, pooled = ctx.saved_tensors
        dfm = ctx.bwd(fm, boxes, box_mask, pooled, g.contiguous(), *ctx.args)
        return dfm, None, None, None, None, None, None, None


def roi_pool(
    fm: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: Optional[torch.Tensor],
    spatial_scale: float,
    out_h: int = 3,
    out_w: int = 3,
) -> torch.Tensor:
    """Batched RoIPool. fm: [B, H, W, C] bf16 or f32; boxes: [B, P, 4]
    x1y1x2y2 (image coords); box_mask: [B, P] bool or None.
    Returns [B, P, out_h, out_w, C] in fm.dtype. Differentiable in fm (the
    backward kernel on CUDA)."""
    if torch.is_grad_enabled() and fm.requires_grad:
        return _RoIPool.apply(fm, boxes, box_mask, spatial_scale, out_h,
                              out_w, _forward, roi_pool_backward)
    return _forward(fm, boxes, box_mask, spatial_scale, out_h, out_w)


def roi_pool_plain(
    fm: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: Optional[torch.Tensor],
    spatial_scale: float,
    out_h: int = 3,
    out_w: int = 3,
) -> torch.Tensor:
    """``roi_pool`` through the plain forward and backward on any device:
    the same function and gradient, with no kernel launched."""
    if torch.is_grad_enabled() and fm.requires_grad:
        return _RoIPool.apply(fm, boxes, box_mask, spatial_scale, out_h,
                              out_w, roi_pool_reference,
                              roi_pool_backward_reference)
    return roi_pool_reference(fm, boxes, box_mask, spatial_scale, out_h,
                              out_w)


roi_pool.launches = 0
roi_pool_backward.launches = 0
