"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode) and skips elsewhere. This file imports neither JAX nor ``cova_tpu``,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

The forward kernels must equal their plain versions bit for bit: the
RoIPool forward selects input values, and the fused BN+ReLU+pool forward
rounds the affine exactly as the plain version does. So must the backward
kernels' main outputs: the RoIPool backward adds each pixel's contributions
in the plain version's order, and the stem pool's backward routes and adds
as its plain version does. Its d(scale)/d(shift) are sums over the whole
map in another order: rtol 1e-4, and atol 1e-4 of the largest of them
(f32 sums of up to a million terms). The bf16 inputs sit on a coarse grid,
so ties are common and the tie rules run (see the notes in ``csrc/``).

The 3x3 conv kernels sum their nine products in another order than the
plain version and round once: bf16 within 2^-7 of the largest output, f32
within 1e-5 of it.
"""

import numpy as np
import pytest
import torch

from cova_tpu_torch.ops.bn_pool import (
    bn_relu_pool_s2d,
    bn_relu_pool_s2d_backward,
    bn_relu_pool_s2d_backward_reference,
    bn_relu_pool_s2d_plain,
    bn_relu_pool_s2d_reference,
)
from cova_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_plain,
    conv3x3_reference,
    conv3x3_roll,
)
from cova_tpu_torch.ops.roi_pool import (
    roi_pool,
    roi_pool_backward,
    roi_pool_backward_reference,
    roi_pool_plain,
    roi_pool_reference,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _boxes(rng, b, p, img):
    x1 = rng.uniform(-10, img - 4, (b, p))
    y1 = rng.uniform(-10, img - 4, (b, p))
    x2 = x1 + rng.uniform(0.5, img + 10 - x1)
    y2 = y1 + rng.uniform(0.5, img + 10 - y1)
    boxes = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
    mask = rng.random((b, p)) < 0.8
    mask[-1] = False  # one page that is all padding
    return torch.from_numpy(boxes), torch.from_numpy(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,out", [(64, (3, 3)), (6, (2, 4)), (130, (1, 1))])
def test_roi_pool_kernel_is_bit_exact(cuda, dtype, c, out):
    rng = np.random.default_rng(c)
    h, w, img = 40, 36, 160
    fm = torch.from_numpy(rng.normal(size=(3, h, w, c)).astype(np.float32))
    boxes, mask = _boxes(rng, 3, 50, img)
    args = (fm.to(cuda, dtype), boxes.to(cuda), mask.to(cuda), 0.25, *out)
    before = roi_pool.launches
    got = roi_pool(*args)
    torch.cuda.synchronize()
    assert roi_pool.launches == before + 1
    want = roi_pool_reference(*args)
    assert got.shape == want.shape == (3, 50, *out, c)
    assert torch.equal(got, want)
    assert not got[~mask.to(cuda)].any()  # masked boxes are zero


@pytest.mark.cuda
def test_roi_pool_kernel_rejects_what_it_does_not_take(cuda):
    fm = torch.zeros(1, 8, 8, 5, device=cuda)  # odd channel count
    boxes = torch.zeros(1, 2, 4, device=cuda)
    with pytest.raises(ValueError):
        roi_pool(fm, boxes, None, 0.25)
    with pytest.raises(TypeError):
        roi_pool(fm[..., :4].to(torch.float16), boxes, None, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 20, 18, 64), (1, 7, 5, 6),
                                   (10, 320, 320, 64)])
def test_bn_relu_pool_kernel_is_bit_exact(cuda, dtype, shape):
    b, u, v, o = shape
    gen = torch.Generator(device=cuda).manual_seed(u * v + o)
    ys = torch.randn(b, u, v, 4 * o, generator=gen, device=cuda).to(dtype)
    scale = torch.randn(o, generator=gen, device=cuda)
    shift = torch.randn(o, generator=gen, device=cuda)
    before = bn_relu_pool_s2d.launches
    got = bn_relu_pool_s2d(ys, scale, shift)
    torch.cuda.synchronize()
    assert bn_relu_pool_s2d.launches == before + 1
    assert torch.equal(got, bn_relu_pool_s2d_reference(ys, scale, shift))


def _tied(gen, shape, dtype, device, levels=8.0):
    """Normal values rounded to 1/levels: many exact ties."""
    x = torch.randn(*shape, generator=gen, device=device)
    return ((x * levels).round() / levels).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,p", [(3, 40, 36, 64, 50), (2, 13, 9, 6, 7),
                                       (2, 320, 320, 64, 232)])
def test_roi_pool_backward_kernel_is_bit_exact(cuda, dtype, b, h, w, c, p):
    gen = torch.Generator(device=cuda).manual_seed(h * w + c)
    rng = np.random.default_rng(c + p)
    fm = _tied(gen, (b, h, w, c), dtype, cuda, levels=2.0)
    boxes, mask = _boxes(rng, b, p, 4 * max(h, w))
    boxes, mask = boxes.to(cuda), mask.to(cuda)
    pooled = roi_pool_reference(fm, boxes, mask, 0.25)
    g = torch.randn(pooled.shape, generator=gen, device=cuda).to(dtype)
    before = roi_pool_backward.launches
    got = roi_pool_backward(fm, boxes, mask, pooled, g, 0.25)
    torch.cuda.synchronize()
    assert roi_pool_backward.launches == before + 1
    want = roi_pool_backward_reference(fm, boxes, mask, pooled, g, 0.25)
    assert got.dtype == dtype and got.shape == fm.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 20, 18, 64), (1, 7, 5, 6),
                                   (2, 320, 320, 64)])
def test_bn_relu_pool_backward_kernel_matches_plain(cuda, dtype, shape):
    b, u, v, o = shape
    gen = torch.Generator(device=cuda).manual_seed(u * v + o)
    ys = _tied(gen, (b, u, v, 4 * o), dtype, cuda)
    scale = torch.rand(o, generator=gen, device=cuda) + 0.5
    shift = torch.randn(o, generator=gen, device=cuda) * 0.5
    g = torch.randn(b, u, v, o, generator=gen, device=cuda).to(dtype)
    before = bn_relu_pool_s2d_backward.launches
    dys, dsc, dsh = bn_relu_pool_s2d_backward(ys, scale, shift, g)
    torch.cuda.synchronize()
    assert bn_relu_pool_s2d_backward.launches == before + 1
    w_dys, w_dsc, w_dsh = bn_relu_pool_s2d_backward_reference(
        ys, scale, shift, g)
    assert dys.dtype == dtype and torch.equal(dys, w_dys)
    for got, want in ((dsc, w_dsc), (dsh, w_dsh)):
        assert got.shape == (o,) and got.dtype == torch.float32
        torch.testing.assert_close(
            got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_the_kernels_equals_the_plain_pairs(cuda, dtype):
    """The differentiable wrappers launch forward and backward kernels and
    give the gradients of the plain (forward, backward) pairs."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    rng = np.random.default_rng(7)
    o = 64
    ys = _tied(gen, (2, 24, 20, 4 * o), dtype, cuda)
    scale = torch.rand(o, generator=gen, device=cuda) + 0.5
    shift = torch.randn(o, generator=gen, device=cuda) * 0.5
    boxes, mask = _boxes(rng, 2, 30, 96)
    boxes, mask = boxes.to(cuda), mask.to(cuda)
    gout = torch.randn(2, 30, 3, 3, o, generator=gen, device=cuda)
    grads = {}
    for name, pool, roi in (("kernel", bn_relu_pool_s2d, roi_pool),
                            ("plain", bn_relu_pool_s2d_plain,
                             roi_pool_plain)):
        args = [t.clone().requires_grad_() for t in (ys, scale, shift)]
        counts = (bn_relu_pool_s2d.launches,
                  bn_relu_pool_s2d_backward.launches, roi_pool.launches,
                  roi_pool_backward.launches)
        fm = pool(*args)
        out = roi(fm, boxes, mask, 0.25)
        (out.float() * gout).sum().backward()
        torch.cuda.synchronize()
        launched = [n1 - n0 for n0, n1 in zip(counts, (
            bn_relu_pool_s2d.launches, bn_relu_pool_s2d_backward.launches,
            roi_pool.launches, roi_pool_backward.launches))]
        assert launched == ([1, 1, 1, 1] if name == "kernel" else [0] * 4)
        grads[name] = [a.grad for a in args]
    k, p = grads["kernel"], grads["plain"]
    assert torch.equal(k[0], p[0])
    for a, b in zip(k[1:], p[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,o", [((2, 13, 37, 48), 256),
                                     ((2, 13, 37, 256), 48),
                                     ((1, 9, 30, 64), 64),
                                     ((1, 40, 31, 128), 128)])
def test_conv3x3_kernels_match_plain(cuda, dtype, shape, o):
    """Both schedules at ragged sizes (tiles cut at the right and bottom
    edges, C and O chunked), and dx through the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    k = torch.randn(3, 3, c, o, generator=gen, device=cuda) * (
        2.0 / (9 * c)) ** 0.5
    want = conv3x3_reference(x, k)
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(
        want.float().abs().max())
    n7, n8 = conv3x3.launches, conv3x3_roll.launches
    for fn in (conv3x3, conv3x3_roll):
        got = fn(x, k)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        assert float((got.float() - want.float()).abs().max()) <= tol
    assert (conv3x3.launches, conv3x3_roll.launches) == (n7 + 1, n8 + 1)
    g = torch.randn(want.shape, generator=gen, device=cuda).to(dtype)
    grads = []
    for fn in (conv3x3, conv3x3_plain):
        xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(xg, kg), (xg, kg), g))
    assert conv3x3.launches == n7 + 3  # forward and dx; dW is a library conv
    dx_tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(
        grads[1][0].float().abs().max())
    assert float((grads[0][0].float() - grads[1][0].float()).abs().max()
                 ) <= dx_tol
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=2e-2,
                               atol=2e-2 * float(grads[1][1].abs().max()))


@pytest.mark.cuda
def test_conv3x3_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 24, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        conv3x3(x, torch.zeros(3, 3, 24, 16, device=cuda))
    with pytest.raises(TypeError, match="unsupported dtype"):
        conv3x3(x[..., :16].half(), torch.zeros(3, 3, 16, 16, device=cuda))
    with pytest.raises(ValueError, match="need x"):
        conv3x3_roll(x[..., :16], torch.zeros(3, 3, 32, 16, device=cuda))
