"""The port's backward ops against the JAX package's Pallas VJPs, on the
same numpy inputs.

The JAX side runs ``jax.grad`` through its Pallas kernels in interpret mode,
as the JAX package's own tests do; the port's wrappers take their plain
PyTorch versions for CPU tensors. The CUDA kernels are held against those
plain versions in ``test_torch_port_kernels.py``, which needs a GPU.

Both backward kernels give every tied maximum the full cotangent (RoIPool)
or follow a fixed tie rule (the fused stem pool), which autodiff of a max
does not. So the tie-free cases use scaled permutations, and the tied cases
use values on a coarse grid that are exact in f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.models.layers import MaskedBatchNorm as JaxBN
from cova_tpu.ops.bn_pool import _pick_tu
from cova_tpu.ops.bn_pool import bn_relu_pool_s2d as jax_bn_relu_pool
from cova_tpu.ops.roi_pool_pallas import roi_pool_pallas
from cova_tpu_torch.models.layers import MaskedBatchNorm
from cova_tpu_torch.ops.bn_pool import (
    bn_relu_pool_s2d,
    bn_relu_pool_s2d_backward,
    bn_relu_pool_s2d_backward_reference,
    bn_relu_pool_s2d_plain,
    bn_relu_pool_s2d_reference,
)
from cova_tpu_torch.ops.roi_pool import (
    roi_pool,
    roi_pool_backward,
    roi_pool_backward_reference,
    roi_pool_plain,
    roi_pool_reference,
)


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


# ---------------------------------------------------- BN + ReLU + pool (K6)


def _unique_ys(b, u, v, c4, seed):
    """Strictly distinct f32 values (``tests/test_bn_pool.py``'s
    construction), so no two taps tie."""
    rng = np.random.default_rng(seed)
    n = b * u * v * c4
    vals = (rng.permutation(n).astype(np.float64) / n * 4.0 - 2.0)
    return vals.astype(np.float32).reshape(b, u, v, c4)


def _jax_bn_pool_grads(ys, scale, shift, g):
    def loss(ys, scale, shift):
        out = jax_bn_relu_pool(ys, scale, shift, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(ys), jnp.asarray(scale), jnp.asarray(shift))]


@pytest.mark.parametrize("u", [16, 40])
def test_bn_pool_backward_matches_pallas_tie_free(u):
    """Tie-free f32 inputs; u = 40 tiles the JAX kernel into 5 row tiles,
    so its middle tiles (both halo rows real) are covered. rtol 1e-4 /
    atol 1e-5, as ``tests/test_bn_pool.py``: d(scale) and d(shift) are
    sums over the map taken in another order."""
    o = 8
    assert _pick_tu(u) in (8, 16) and u // _pick_tu(u) >= 2
    rng = np.random.default_rng(u)
    ys = _unique_ys(2, u, 16, 4 * o, seed=u)
    scale = (np.abs(rng.normal(size=(o,))) + 0.1).astype(np.float32)
    shift = rng.normal(size=(o,)).astype(np.float32)
    g = rng.normal(size=(2, u, 16, o)).astype(np.float32)
    want = _jax_bn_pool_grads(ys, scale, shift, g)
    got = bn_relu_pool_s2d_backward_reference(_t(ys), _t(scale), _t(shift),
                                              _t(g))
    assert got[0].shape == ys.shape and got[1].shape == got[2].shape == (o,)
    for name, a, b in zip(["dys", "dscale", "dshift"], got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_bn_pool_backward_matches_pallas_with_ties():
    """Ties everywhere: ys on a k/8 grid in [-1, 1], dyadic scale and
    shift, so every affine value is exact in f32 (a fused multiply-add
    rounds the same) and equal taps stay equal. Winners, and so dys, must
    be equal exactly. d(scale)/d(shift) sum a few thousand terms of
    magnitude <= 4 in another order: atol 1e-4."""
    o, u = 8, 16
    rng = np.random.default_rng(5)
    ys = (rng.integers(-8, 9, size=(2, u, 16, 4 * o)) / 8).astype(np.float32)
    scale = (rng.integers(1, 9, size=(o,)) / 4).astype(np.float32)
    shift = (rng.integers(-4, 5, size=(o,)) / 4).astype(np.float32)
    g = rng.normal(size=(2, u, 16, o)).astype(np.float32)
    want = _jax_bn_pool_grads(ys, scale, shift, g)
    dys, dscale, dshift = bn_relu_pool_s2d_backward_reference(
        _t(ys), _t(scale), _t(shift), _t(g))
    # Ties do occur among the winners' candidates.
    assert len(np.unique(ys)) <= 17
    np.testing.assert_array_equal(dys.numpy(), want[0])
    np.testing.assert_allclose(dscale.numpy(), want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(dshift.numpy(), want[2], rtol=0, atol=1e-4)


def test_bn_pool_backward_tie_rule_is_not_autograd():
    """On tied inputs the plain backward follows the kernel's rule (one
    winner takes the whole cotangent) where autograd of the plain forward
    splits it: the two differ, and the rule's dys sums to g's routed
    mass."""
    o = 2
    ys = torch.ones(1, 2, 2, 4 * o)  # every tap ties
    scale, shift = torch.ones(o), torch.zeros(o)
    g = torch.ones(1, 2, 2, o)
    dys, _, _ = bn_relu_pool_s2d_backward_reference(ys, scale, shift, g)
    ys_ = ys.clone().requires_grad_()
    auto, = torch.autograd.grad(
        (bn_relu_pool_s2d_reference(ys_, scale, shift) * g).sum(), ys_)
    assert not torch.equal(dys, auto)
    assert float(dys.sum()) == float(g.sum())  # one winner per output
    assert set(dys.unique().tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}


def test_bn_pool_autograd_equals_plain_backward():
    """``torch.autograd.grad`` through ``bn_relu_pool_s2d`` (and its
    plain-pair twin) gives the plain backward's tensors: dys for ys and
    [O]-shaped gradients for scale and shift."""
    o = 8
    rng = np.random.default_rng(9)
    ys = _unique_ys(2, 16, 16, 4 * o, seed=9)
    scale = (np.abs(rng.normal(size=(o,))) + 0.1).astype(np.float32)
    shift = rng.normal(size=(o,)).astype(np.float32)
    g = _t(rng.normal(size=(2, 16, 16, o)).astype(np.float32))
    want = bn_relu_pool_s2d_backward_reference(_t(ys), _t(scale),
                                               _t(shift), g)
    before = (bn_relu_pool_s2d.launches, bn_relu_pool_s2d_backward.launches)
    for op in (bn_relu_pool_s2d, bn_relu_pool_s2d_plain):
        args = [_t(a).requires_grad_() for a in (ys, scale, shift)]
        out = op(*args)
        got = torch.autograd.grad((out * g).sum(), args)
        assert got[1].shape == got[2].shape == (o,)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # On the CPU no kernel ran, and without grad no autograd node is made.
    assert (bn_relu_pool_s2d.launches,
            bn_relu_pool_s2d_backward.launches) == before
    with torch.no_grad():
        assert bn_relu_pool_s2d(*[_t(a).requires_grad_() for a in
                                  (ys, scale, shift)]).grad_fn is None


def test_stem_bn_pool_gradients_match_jax():
    """The stem's training path: ``MaskedBatchNorm`` with the group fold
    (g = 4) returns coefficients that depend on ys through the batch
    statistics, and the fused pool's backward sends d(scale)/d(shift)
    through them. Gradients for ys, gamma and beta equal ``jax.grad`` of
    the JAX package's same two steps (its Pallas pair in interpret mode):
    tie-free f32, rtol 1e-4 / atol 1e-5 of the largest gradient."""
    o = 8
    rng = np.random.default_rng(21)
    ys = _unique_ys(2, 16, 16, 4 * o, seed=21)
    gamma = rng.uniform(0.5, 1.5, o).astype(np.float32)
    beta = rng.normal(0.0, 0.5, o).astype(np.float32)
    g = rng.normal(size=(2, 16, 16, o)).astype(np.float32)
    stats = {"mean": np.zeros(o, np.float32), "var": np.ones(o, np.float32)}
    mod = JaxBN(features=o, group_fold=4)

    def jax_loss(ys, gamma, beta):
        (sc, sh), _ = mod.apply(
            {"params": {"scale": gamma, "bias": beta},
             "batch_stats": stats}, ys, None, use_running_average=False,
            return_coefficients=True, mutable=["batch_stats"])
        out = jax_bn_relu_pool(ys, sc, sh, interpret=True)
        return jnp.sum(out * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(ys), jnp.asarray(gamma), jnp.asarray(beta))
    bn = MaskedBatchNorm(o).train()
    with torch.no_grad():
        bn.weight.copy_(_t(gamma))
        bn.bias.copy_(_t(beta))
    x = _t(ys).requires_grad_()
    out = bn_relu_pool_s2d(x, *bn(x, return_coefficients=True))
    (out * _t(g)).sum().backward()
    for name, a, b in zip(("ys", "gamma", "beta"),
                          (x.grad, bn.weight.grad, bn.bias.grad), want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)


# --------------------------------------------------------------- RoIPool


def _roi_boxes():
    """Tall, chunk-aligned, overlapping, nested, clipped, sub-chunk and
    masked boxes over a 48 x 16 map at spatial scale 1/4
    (``tests/test_roi_pool_pallas.py``'s geometries)."""
    boxes = np.array([[
        [0.0, 0.0, 63.0, 191.0],     # full height: many chunks per bin
        [4.0, 0.0, 40.0, 95.0],      # bins chunk-aligned at 0/8/16/24
        [0.0, 32.0, 20.0, 46.0],     # short box, one chunk per bin
        [8.0, 180.0, 30.0, 191.0],   # bottom-clipped
        [12.0, 50.0, 50.0, 130.0],   # unaligned edges and interiors
        [12.0, 50.0, 50.0, 130.0],   # identical duplicate
        [16.0, 60.0, 40.0, 100.0],   # nested
        [2.0, 3.0, 5.0, 6.0],        # sub-chunk: bins of one pixel
        [0.0, 0.0, 63.0, 191.0],     # masked below
    ]], np.float32)
    mask = np.ones((1, boxes.shape[1]), bool)
    mask[0, -1] = False
    return boxes, mask


def _jax_roi_grad(fm, boxes, mask, g):
    def loss(f):
        out = roi_pool_pallas(f, jnp.asarray(boxes), jnp.asarray(mask),
                              0.25, 3, 3, True)
        return jnp.sum(out * jnp.asarray(g))

    return np.asarray(jax.grad(loss)(jnp.asarray(fm)))


@pytest.mark.parametrize("bwd", ["pyramid", "walk"])
def test_roi_pool_backward_matches_pallas_tie_free(bwd, monkeypatch):
    """Tie-free f32 map: both route each bin's cotangent to its one
    maximum, so they differ only in the order a pixel's contributions from
    overlapping boxes are added (rtol 1e-5 / atol 1e-6)."""
    monkeypatch.setenv("COVA_ROI_BWD", bwd)
    rng = np.random.default_rng(11)
    b, h, w, c = 1, 48, 16, 4
    n = b * h * w * c
    fm = (rng.permutation(n) / n * 4 - 2).astype(np.float32).reshape(
        b, h, w, c)
    boxes, mask = _roi_boxes()
    g = rng.normal(size=(b, boxes.shape[1], 3, 3, c)).astype(np.float32)
    want = _jax_roi_grad(fm, boxes, mask, g)
    pooled = roi_pool_reference(_t(fm), _t(boxes), _t(mask), 0.25)
    got = roi_pool_backward_reference(_t(fm), _t(boxes), _t(mask), pooled,
                                      _t(g), 0.25)
    assert got.shape == fm.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bwd", ["pyramid", "walk"])
def test_roi_pool_backward_full_cotangent_per_tie(bwd, monkeypatch):
    """fm on a coarse grid (values k/2, many ties per bin) and a constant
    cotangent per channel: every tied maximum gets the full cotangent, in
    both, and the sums are small integers times g, exact in f32."""
    monkeypatch.setenv("COVA_ROI_BWD", bwd)
    rng = np.random.default_rng(12)
    b, h, w, c = 1, 48, 16, 4
    fm = (rng.integers(0, 4, size=(b, h, w, c)) / 2).astype(np.float32)
    boxes, mask = _roi_boxes()
    g = np.broadcast_to(
        np.array([1.0, 0.5, -2.0, 0.25], np.float32),
        (b, boxes.shape[1], 3, 3, c)).copy()
    want = _jax_roi_grad(fm, boxes, mask, g)
    pooled = roi_pool_reference(_t(fm), _t(boxes), _t(mask), 0.25)
    got = roi_pool_backward_reference(_t(fm), _t(boxes), _t(mask), pooled,
                                      _t(g), 0.25).numpy()
    np.testing.assert_array_equal(got, want)
    # Ties got more than one share: some bin routed g to several pixels.
    assert (got[..., 0] >= 2).sum() > (got[..., 0] > 0).sum() / 10


def test_roi_pool_autograd_equals_plain_backward():
    """``torch.autograd.grad`` through ``roi_pool`` (and its plain-pair
    twin) gives the plain backward's dfm and no gradient for the boxes."""
    rng = np.random.default_rng(13)
    fm = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    x1 = rng.uniform(-10, 60, (2, 12))
    y1 = rng.uniform(-10, 60, (2, 12))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.5, 40, (2, 12)),
                      y1 + rng.uniform(0.5, 40, (2, 12))], -1)
    boxes = _t(boxes.astype(np.float32))
    mask = _t(rng.random((2, 12)) < 0.75)
    g = _t(rng.normal(size=(2, 12, 3, 3, 8)).astype(np.float32))
    pooled = roi_pool_reference(_t(fm), boxes, mask, 0.25)
    want = roi_pool_backward_reference(_t(fm), boxes, mask, pooled, g, 0.25)
    assert torch.equal(roi_pool_backward(_t(fm), boxes, mask, pooled, g,
                                         0.25), want)
    before = (roi_pool.launches, roi_pool_backward.launches)
    for op in (roi_pool, roi_pool_plain):
        f = _t(fm).requires_grad_()
        bx = boxes.clone().requires_grad_()
        out = op(f, bx, mask, 0.25)
        assert torch.equal(out.detach(), pooled)
        dfm, dbox = torch.autograd.grad((out * g).sum(), (f, bx),
                                        allow_unused=True)
        assert torch.equal(dfm, want)
        assert dbox is None
    assert (roi_pool.launches, roi_pool_backward.launches) == before
