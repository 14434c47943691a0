"""The launch plans and the schedule-following plain versions of the port's
RoIPool forward (K1) and backward (K3), and fused stem BN+ReLU+pool forward
(K5) and backward (K6) kernels (``cova_tpu_torch/ops/roi_pool.py``,
``ops/bn_pool.py``), on the CPU.

The CUDA kernels run only on the card, so what can be checked here is their
decomposition: ``roi_pool_pyramid_reference`` builds the chunk-max pyramid
and splits every bin into edge rows, pyramid chunks and pixel slots as the
kernel does; ``roi_pool_backward_tiled_reference`` lists each tile's (box,
bin) pairs in the kernel's order and capacity and walks them;
``bn_relu_pool_s2d_tiled_reference`` stages the forward kernel's tiles with
their halo row and column and takes the maxima in its three stages;
``bn_relu_pool_s2d_backward_tiled_reference`` walks the backward kernel's
tiles with their halos, computes each output's winner code once and gathers
in the kernel's order. All must equal the plain versions bit for bit (K6's
d(scale)/d(shift): within rtol 1e-5, f32 sums in another order), and one
case of each must match the JAX package's Pallas kernel in interpret mode.
The plans are held to the card's shared memory.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.ops.bn_pool import bn_relu_pool_s2d as jax_bn_relu_pool
from cova_tpu.ops.roi_pool_pallas import roi_pool_pallas
from cova_tpu_torch.ops import bn_pool, roi_pool
from cova_tpu_torch.ops.bn_pool import (
    bn_relu_pool_s2d_backward_reference,
    bn_relu_pool_s2d_backward_tiled_reference,
    bn_relu_pool_s2d_reference,
    bn_relu_pool_s2d_tiled_reference,
    bwd_plan,
    fwd_plan,
)
from cova_tpu_torch.ops.roi_pool import (
    _tile_lists,
    bin_rows,
    roi_bounds,
    roi_bwd_plan,
    roi_bwd_tile_pairs,
    roi_pool_backward_reference,
    roi_pool_backward_tiled_reference,
    roi_pool_plan,
    roi_pool_pyramid_reference,
    roi_pool_reference,
)

DTYPES = [torch.float32, torch.bfloat16]
CHUNK = roi_pool.ROI_CHUNK


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("h", [1, 7, 8, 9, 17, 24, 41])
def test_bin_rows_cover_each_bin_exactly(h):
    """Every row range [ylo, yhi) of a map of h rows: the edge rows and the
    chunks (chunk k holds rows [8k, min(h, 8k + 8))) cover exactly the
    bin's rows, with chunk indices inside the pyramid; a bin whose ends sit
    on chunk boundaries (or on the map's last row) has no edge rows, and one
    inside a chunk has no chunk."""
    n_chunks = -(-h // CHUNK)
    for ylo in range(h):
        for yhi in range(ylo + 1, h + 1):
            (t0, t1), (c0, c1), (e0, e1) = bin_rows(ylo, yhi, h)
            assert 0 <= c0 <= c1 <= n_chunks
            rows = list(range(t0, t1)) + list(range(e0, e1))
            for k in range(c0, c1):
                rows += range(k * CHUNK, min(h, k * CHUNK + CHUNK))
            assert sorted(rows) == list(range(ylo, yhi)), (ylo, yhi)
            lo_edge = ylo % CHUNK == 0
            hi_edge = yhi % CHUNK == 0 or yhi == h
            if lo_edge and hi_edge and c1 > c0:
                assert t1 == t0 and e1 == e0
            if ylo // CHUNK == (yhi - 1) // CHUNK and not (lo_edge and hi_edge):
                assert c0 == c1


def _roi_boxes(rng, b, p, h, w, special):
    """Random boxes in image coordinates (4x the map), some beyond it, with
    ``special`` boxes first."""
    img_h, img_w = 4 * h, 4 * w
    x1 = rng.uniform(-10, img_w - 4, (b, p))
    y1 = rng.uniform(-10, img_h - 4, (b, p))
    x2 = x1 + rng.uniform(0.5, img_w + 10 - x1)
    y2 = y1 + rng.uniform(0.5, img_h + 10 - y1)
    boxes = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    for k, box in enumerate(special):
        boxes[:, k] = box
    mask = rng.random((b, p)) < 0.8
    mask[:, : len(special)] = True
    return boxes, mask


# (name, (B, H, W, C, P), (out_h, out_w), special boxes, all masked).
ROI_CASES = [
    # roi of 3 rows over 3 bins: one row each, at rows 10, 11, 12.
    ("bins_of_one_row", (2, 24, 20, 4, 9), (3, 3),
     [(8, 40, 60, 48), (0, 0, 8, 8)], False),
    # rows 17 .. 22: inside chunk 2, no chunk of the pyramid is used.
    ("inside_one_chunk", (2, 24, 20, 6, 9), (3, 3),
     [(4, 68, 70, 88), (0, 66, 30, 92)], False),
    # rows 8 .. 31 in 3 bins: every bin is one whole chunk, no edge rows.
    ("on_chunk_boundaries", (2, 40, 20, 4, 9), (3, 3),
     [(0, 32, 76, 124), (12, 64, 70, 127)], False),
    ("h_not_a_multiple_of_the_chunk", (2, 37, 29, 4, 12), (3, 3),
     [(0, 100, 110, 147), (10, 5, 60, 140)], False),
    ("whole_map", (2, 33, 17, 6, 5), (3, 3),
     [(0, 0, 4 * 17, 4 * 33), (-20, -20, 500, 500)], False),
    ("all_masked", (2, 20, 20, 4, 7), (3, 3), [], True),
    ("out_h_ne_out_w", (2, 30, 26, 4, 10), (2, 4),
     [(0, 0, 4 * 26, 4 * 30)], False),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ROI_CASES, ids=lambda c: c[0])
def test_pyramid_reference_is_bit_exact(case, dtype):
    name, (b, h, w, c, p), (oh, ow), special, all_masked = case
    rng = np.random.default_rng(len(name) + c)
    fm = _t(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(dtype)
    boxes, mask = _roi_boxes(rng, b, p, h, w, special)
    if all_masked:
        mask[:] = False
    args = (fm, _t(boxes), _t(mask), 0.25, oh, ow)
    want = roi_pool_reference(*args)
    got = roi_pool_pyramid_reference(*args)
    assert got.dtype == dtype and got.shape == (b, p, oh, ow, c)
    assert torch.equal(got, want)
    assert not got[~_t(mask)].any()
    if all_masked:
        assert not got.any()


def test_pyramid_reference_matches_pallas_interpret():
    """f32, exact: both take a max of the same inputs over the same bins."""
    rng = np.random.default_rng(11)
    b, h, w, c, p = 2, 37, 20, 8, 12
    fm = rng.normal(size=(b, h, w, c)).astype(np.float32)
    boxes, mask = _roi_boxes(rng, b, p, h, w, [(0, 32, 60, 124)])
    want = np.asarray(roi_pool_pallas(
        jnp.asarray(fm), jnp.asarray(boxes), jnp.asarray(mask), 0.25, 3, 3,
        True))
    got = roi_pool_pyramid_reference(_t(fm), _t(boxes), _t(mask), 0.25)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,c,aligned,vec", [
    (torch.bfloat16, 64, True, 8), (torch.bfloat16, 6, True, 2),
    (torch.bfloat16, 130, True, 2), (torch.bfloat16, 64, False, 2),
    (torch.float32, 64, True, 4), (torch.float32, 6, True, 2),
])
def test_roi_pool_plan(dtype, c, aligned, vec):
    """16 bytes a lane where C allows it; the slots and channel vectors of
    one pass fill at most the block; the pyramid holds ceil(H / 8) chunks;
    and the static shared memory is far inside the card's 227 KB."""
    plan = roi_pool_plan(dtype, 10, 232, 37, 29, c, 3, 3, aligned)
    assert plan.vec == vec and c % plan.vec == 0
    assert plan.vecs_per_pass == min(c // vec, plan.threads)
    assert plan.slots * plan.vecs_per_pass <= plan.threads
    assert plan.pyramid_shape == (10, 5, 29, c) and plan.n_chunks == 5
    assert plan.n_items == 10 * 232 * 9
    assert plan.smem_bytes <= bn_pool.SMEM_MAX


def test_roi_pool_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        roi_pool_plan(torch.float32, 1, 1, 8, 8, 5, 3, 3)
    with pytest.raises(ValueError):
        roi_pool_plan(torch.float32, 1, 1, 8, 8, 4, 5, 7)
    with pytest.raises(TypeError):
        roi_pool_plan(torch.float16, 1, 1, 8, 8, 4, 3, 3)


# ---------------------------------------------------------------- K3


def _tied_roi_case(name, b, h, w, c, p, special, all_masked, dtype):
    """fm on a coarse grid (values k/2: many ties in every bin), the boxes
    of ``_roi_boxes`` and a cotangent in fm's dtype."""
    rng = np.random.default_rng(len(name) + c + 100)
    fm = _t((rng.integers(-3, 4, size=(b, h, w, c)) / 2).astype(
        np.float32)).to(dtype)
    boxes, mask = _roi_boxes(rng, b, p, h, w, special)
    if all_masked:
        mask[:] = False
    g = _t(rng.normal(size=(b, p, 1, 1, c)).astype(np.float32))
    return fm, _t(boxes), _t(mask), g


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ROI_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("small_list", [False, True],
                         ids=["default_plan", "list_of_8"])
def test_backward_tiled_reference_is_bit_exact(case, dtype, small_list):
    """Ties everywhere, masked boxes, empty bins (rois shorter than the
    bins), boxes past the map's edge; with the default plan and with a pair
    list of 8 filled 4 candidates at a time and staged 3 pairs at a time, so
    tiles walk their pairs in several lists and chunks: dfm bit for bit."""
    name, (b, h, w, c, p), (oh, ow), special, all_masked = case
    fm, boxes, mask, g1 = _tied_roi_case(name, b, h, w, c, p, special,
                                         all_masked, dtype)
    pooled = roi_pool_reference(fm, boxes, mask, 0.25, oh, ow)
    g = g1.expand(b, p, oh, ow, c).contiguous().to(dtype)
    plan = roi_bwd_plan(dtype, b, p, h, w, c, oh, ow)
    if small_list:
        plan = roi_bwd_plan(dtype, b, p, h, w, c, oh, ow, cap=8, round_=4,
                            chunk=3)
        bd = roi_bounds(boxes, mask, 0.25, oh, ow, h, w).tolist()
        n_lists = max(len(_tile_lists(bd[0], y0, x0, 8, 8, oh, ow, plan))
                      for y0 in range(0, h, 8) for x0 in range(0, w, 8))
        assert all_masked or n_lists > 1
    args = (fm, boxes, mask, pooled, g, 0.25, oh, ow)
    want = roi_pool_backward_reference(*args)
    got = roi_pool_backward_tiled_reference(*args, plan=plan)
    assert got.dtype == dtype and got.shape == fm.shape
    assert torch.equal(got, want)
    if not all_masked:
        assert bool((want != 0).any())  # gradient flowed


def test_backward_tiled_reference_matches_pallas_interpret_tie_free():
    """Tie-free f32 map: each bin routes its cotangent to its one maximum
    in both; the Pallas pyramid backward adds a pixel's contributions from
    overlapping boxes in another order (its chunk routing), so rtol 1e-5
    and atol 1e-6, as ``test_torch_port_backward.py`` holds the plain
    version."""
    rng = np.random.default_rng(13)
    b, h, w, c, p = 2, 37, 20, 8, 12
    n = b * h * w * c
    fm = (rng.permutation(n) / n * 4 - 2).astype(np.float32).reshape(
        b, h, w, c)
    boxes, mask = _roi_boxes(rng, b, p, h, w, [(0, 32, 60, 124),
                                               (0, 0, 80, 148)])
    g = rng.normal(size=(b, p, 3, 3, c)).astype(np.float32)

    def loss(f):
        out = roi_pool_pallas(f, jnp.asarray(boxes), jnp.asarray(mask), 0.25,
                              3, 3, True)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(fm)))
    pooled = roi_pool_reference(_t(fm), _t(boxes), _t(mask), 0.25)
    got = roi_pool_backward_tiled_reference(_t(fm), _t(boxes), _t(mask),
                                            pooled, _t(g), 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ROI_CASES[:5], ids=lambda c: c[0])
def test_tile_pairs_count_the_kernels_lists(case):
    """``roi_bwd_tile_pairs`` (what ``chip_smoke.py`` reports per tile)
    counts exactly the pairs of the kernel's lists."""
    name, (b, h, w, c, p), (oh, ow), special, _ = case
    rng = np.random.default_rng(len(name))
    boxes, mask = _roi_boxes(rng, b, p, h, w, special)
    bd = roi_bounds(_t(boxes), _t(mask), 0.25, oh, ow, h, w)
    plan = roi_bwd_plan(torch.float32, b, p, h, w, c, oh, ow)
    got = roi_bwd_tile_pairs(bd, h, w, oh, ow, plan.tile)
    rows = bd.tolist()
    want = [[[sum(map(len, _tile_lists(rows[i], y0, x0, 8, 8, oh, ow, plan)))
              for x0 in range(0, w, 8)] for y0 in range(0, h, 8)]
            for i in range(b)]
    assert torch.equal(got, torch.tensor(want))


@pytest.mark.parametrize("dtype,c,aligned,lanes,copy16", [
    (torch.bfloat16, 64, True, 32, True), (torch.bfloat16, 64, False, 32,
                                           False),
    (torch.bfloat16, 6, True, 3, False), (torch.bfloat16, 130, True, 32,
                                          False),
    (torch.float32, 64, True, 32, True), (torch.float32, 512, True, 32,
                                          True),
])
def test_roi_bwd_plan_fits_shared_memory(dtype, c, aligned, lanes, copy16):
    """8 x 8 tiles, a thread per tile row and channel pair (whole warps,
    at most 256 threads), 16-byte stage copies where rows and addresses
    allow, a layout within the card's 227 KB and room for the planned
    blocks on an SM, and a list that takes a whole round."""
    for p in (1, 232, 8192):
        plan = roi_bwd_plan(dtype, 5, p, 320, 320, c, 3, 3, aligned)
        assert plan.tile == (8, 8) and plan.lanes == lanes
        assert plan.passes == -(-(c // 2) // lanes)
        assert plan.threads % 32 == 0 and plan.threads <= 256
        assert plan.threads >= plan.lanes * 8
        assert plan.copy16 == copy16
        assert plan.round <= min(plan.threads, plan.cap)
        assert plan.smem_bytes <= bn_pool.SMEM_MAX
        per_sm = -(-plan.blocks // bn_pool.N_SMS)
        assert per_sm * (plan.smem_bytes + bn_pool.SMEM_RESERVED) <= \
            bn_pool.SMEM_PER_SM
        assert plan.n_tiles == 5 * 40 * 40


def test_roi_bwd_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        roi_bwd_plan(torch.float32, 1, 1, 8, 8, 5, 3, 3)
    with pytest.raises(ValueError):
        roi_bwd_plan(torch.float32, 1, 1, 8, 8, 4, 5, 7)
    with pytest.raises(ValueError):
        roi_bwd_plan(torch.float32, 1, 8193, 8, 8, 4, 3, 3)
    with pytest.raises(ValueError):  # a round larger than the list
        roi_bwd_plan(torch.float32, 1, 1, 8, 8, 4, 3, 3, cap=4, round_=8)
    with pytest.raises(TypeError):
        roi_bwd_plan(torch.float16, 1, 1, 8, 8, 4, 3, 3)


# ---------------------------------------------------------------- K5


def _fwd_plan_with_tile(plan, tile, b, u, v):
    """``plan`` walking tiles of another shape (the plain version follows
    any tile; the kernel takes FWD_TILE only)."""
    n_tiles = b * -(-u // tile[0]) * -(-v // tile[1])
    return plan._replace(tile=tile, n_tiles=n_tiles,
                         n_walkers=min(plan.n_walkers, n_tiles))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("tile", [bn_pool.FWD_TILE, (1, 1), (3, 5), (4, 8)],
                         ids=str)
@pytest.mark.parametrize("ku,kv", [(0, 0), (1, 2), (2, 1), (2, 2)])
def test_fwd_tiled_reference_is_bit_exact(ku, kv, tile, dtype):
    """U and V of 1, one below and one above the tile (8 x 16 is the
    kernel's), with ties: the halo row and column, their -inf at the map's
    top and left, and the three max stages equal the plain version bit for
    bit. O cycles through 6 (pairs of channels), 8 and 64 (several
    chunks)."""
    tu, tv = bn_pool.FWD_TILE
    u, v = _side(tu, ku), _side(tv, kv)
    o = (6, 8, 64)[(ku + 2 * kv) % 3]
    ys, scale, shift, _ = (_t(a) for a in _tied_bn_case(2, u, v, o, u + v))
    ys = ys.to(dtype)
    plan = _fwd_plan_with_tile(fwd_plan(dtype, 2, u, v, o), tile, 2, u, v)
    want = bn_relu_pool_s2d_reference(ys, scale, shift)
    got = bn_relu_pool_s2d_tiled_reference(ys, scale, shift, plan)
    assert got.dtype == dtype and torch.equal(got, want)
    # shift < 0 leaves zeros where the ReLU cut: both must agree there too.
    assert bool((want > 0).any())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fwd_tiled_reference_is_bit_exact_on_continuous_inputs(dtype):
    """Normal ys, scale and shift (the affine rounds in f32): the same."""
    rng = np.random.default_rng(3)
    ys = _t(rng.normal(size=(2, 17, 33, 4 * 64)).astype(np.float32)).to(
        dtype)
    scale = _t(rng.normal(size=(64,)).astype(np.float32))
    shift = _t(rng.normal(size=(64,)).astype(np.float32))
    assert torch.equal(bn_relu_pool_s2d_tiled_reference(ys, scale, shift),
                       bn_relu_pool_s2d_reference(ys, scale, shift))


def test_fwd_tiled_reference_matches_pallas_interpret():
    """Ties everywhere, dyadic values (every affine exact in f32, so the
    Pallas kernel's possible fused multiply-add rounds nothing): equal to
    the Pallas forward in interpret mode."""
    ys, scale, shift, _ = _tied_bn_case(2, 16, 16, 8, seed=9)
    want = np.asarray(jax_bn_relu_pool(
        jnp.asarray(ys), jnp.asarray(scale), jnp.asarray(shift),
        interpret=True))
    got = bn_relu_pool_s2d_tiled_reference(_t(ys), _t(scale), _t(shift))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("aligned", [True, False])
def test_fwd_plan_fits_shared_memory(dtype, aligned):
    """For every even O <= 512: a chunk that divides O in whole accesses
    (16 bytes where O and the address allow), at most 256 threads that
    cover every column of the tile and split its rows evenly, the stages
    within the card's 227 KB with room for the planned blocks on an SM."""
    isz = torch.empty((), dtype=dtype).element_size()
    for o in range(2, 513, 2):
        plan = fwd_plan(dtype, 10, 320, 320, o, aligned=aligned)
        vec = 16 // isz if aligned and o % (16 // isz) == 0 else 2
        assert plan.vec == vec
        assert plan.fc % vec == 0 and o % plan.fc == 0
        assert plan.n_chunks == o // plan.fc
        assert plan.fc == vec or plan.fc * isz <= bn_pool.FWD_CHUNK_BYTES
        tu, tv = plan.tile
        assert tu % plan.row_splits == 0
        assert plan.threads == plan.fc // vec * tv * plan.row_splits <= 256
        assert plan.smem_bytes <= bn_pool.SMEM_MAX
        assert bn_pool.FWD_BLOCKS_PER_SM * (
            plan.smem_bytes + bn_pool.SMEM_RESERVED) <= bn_pool.SMEM_PER_SM
        assert plan.smem_bytes >= 128 + plan.stages * (
            (tu + 1) * 4 * (tv + 1) * plan.fc * isz + 8)
        assert 1 <= plan.n_walkers <= plan.n_tiles == 10 * 40 * 20


def test_fwd_plan_refuses_what_the_kernel_does_not_take():
    for o in (3, 514):
        with pytest.raises(ValueError):
            fwd_plan(torch.float32, 1, 4, 4, o)
    with pytest.raises(ValueError):
        fwd_plan(torch.float32, 1, 4, 4, 8, stages=5)
    with pytest.raises(ValueError):  # no room for 3 blocks of 4 stages
        fwd_plan(torch.bfloat16, 1, 4, 4, 64, stages=4, chunk_bytes=128,
                 blocks_per_sm=3)
    with pytest.raises(TypeError):
        fwd_plan(torch.float16, 1, 4, 4, 8)


# ---------------------------------------------------------------- K6


def _tied_bn_case(b, u, v, o, seed):
    """ys on a k/8 grid in [-1, 1] and dyadic scale and shift: every affine
    value is exact in f32 and bf16, and equal taps stay equal."""
    rng = np.random.default_rng(seed)
    ys = (rng.integers(-8, 9, size=(b, u, v, 4 * o)) / 8).astype(np.float32)
    scale = (rng.integers(1, 9, size=(o,)) / 4).astype(np.float32)
    shift = (rng.integers(-4, 5, size=(o,)) / 4).astype(np.float32)
    g = rng.normal(size=(b, u, v, o)).astype(np.float32)
    return ys, scale, shift, g


def _side(tile_side, k):
    """1, one below the tile's side and one above it."""
    return (1, tile_side - 1, tile_side + 1)[k]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("ku,kv", list(itertools.product(range(3), range(3))))
def test_tiled_reference_is_bit_exact(ku, kv, dtype):
    """U and V of 1, one below and one above the dtype's tile: dys bit for
    bit; d(scale)/d(shift) within rtol 1e-5. O cycles through 6 (pairs of
    channels), 8 (one chunk) and 64 (several chunks)."""
    tu, tv = bn_pool.BWD_TILES[dtype]
    u, v = _side(tu, ku), _side(tv, kv)
    o = (6, 8, 64)[(ku + 2 * kv) % 3]
    ys, scale, shift, g = (_t(a) for a in _tied_bn_case(2, u, v, o, u * v))
    ys, g = ys.to(dtype), g.to(dtype)
    want = bn_relu_pool_s2d_backward_reference(ys, scale, shift, g)
    got = bn_relu_pool_s2d_backward_tiled_reference(ys, scale, shift, g)
    assert got[0].dtype == dtype and torch.equal(got[0], want[0])
    assert bool(want[0].float().abs().sum() > 0)  # gradient flowed
    for a, ref in zip(got[1:], want[1:]):
        assert a.shape == (o,) and a.dtype == torch.float32
        torch.testing.assert_close(
            a, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def test_tiled_reference_matches_pallas_interpret_with_ties():
    """Ties everywhere (``test_torch_port_backward.py``'s construction): dys
    exactly as the Pallas VJP in interpret mode, d(scale)/d(shift) within
    atol 1e-4. The shape is one the Pallas kernel takes (V a multiple of 8;
    elsewhere the JAX package falls back to autodiff, which splits ties)."""
    ys, scale, shift, g = _tied_bn_case(2, 16, 24, 8, seed=5)

    def loss(ys, scale, shift):
        out = jax_bn_relu_pool(ys, scale, shift, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    want = [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(ys), jnp.asarray(scale), jnp.asarray(shift))]
    dys, dscale, dshift = bn_relu_pool_s2d_backward_tiled_reference(
        _t(ys), _t(scale), _t(shift), _t(g))
    np.testing.assert_array_equal(dys.numpy(), want[0])
    np.testing.assert_allclose(dscale.numpy(), want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(dshift.numpy(), want[2], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("aligned", [True, False])
def test_bwd_plan_fits_shared_memory(dtype, aligned):
    """For every even O <= 512: a chunk that divides O in whole accesses,
    at most 256 threads, the layout within the card's 227 KB per block, and
    three blocks to an SM wherever a chunk allows it (always here)."""
    isz = torch.empty((), dtype=dtype).element_size()
    for o in range(2, 513, 2):
        plan = bwd_plan(dtype, 5, 320, 320, o, aligned=aligned)
        vec = 16 // isz if aligned and o % (16 // isz) == 0 else 2
        assert plan.vec == vec
        assert plan.fc % vec == 0 and o % plan.fc == 0
        assert plan.n_chunks == o // plan.fc
        lanes, ny = plan.block
        assert lanes == 4 * plan.fc // vec and lanes * ny <= 256 and ny >= 1
        assert plan.smem_bytes <= bn_pool.SMEM_MAX
        assert 3 * (plan.smem_bytes + bn_pool.SMEM_RESERVED) <= \
            bn_pool.SMEM_PER_SM
        assert plan.smem_bytes >= lanes * ny * 2 * vec * 4  # the sums
        tu, tv = plan.tile
        assert plan.tile == bn_pool.BWD_TILES[dtype]
        assert 1 <= plan.n_walkers <= plan.n_tiles == 5 * (320 // tu) * (
            320 // tv)


def test_bwd_plan_refuses_what_the_kernel_does_not_take():
    for o in (3, 514):
        with pytest.raises(ValueError):
            bwd_plan(torch.float32, 1, 4, 4, o)
    with pytest.raises(TypeError):
        bwd_plan(torch.float16, 1, 4, 4, 8)
