"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode) and skips elsewhere. This file imports neither JAX nor ``cova_tpu``,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py

The forward kernels must equal their plain versions bit for bit: the
RoIPool forward selects input values, and the fused BN+ReLU+pool forward
rounds the affine exactly as the plain version does (at ragged and
unaligned shapes and under several launch plans). So must the backward
kernels' main outputs: the RoIPool backward adds each pixel's contributions
in the plain version's order, and the stem pool's backward routes and adds
as its plain version does. Its d(scale)/d(shift) are sums over the whole
map in another order: rtol 1e-4, and atol 1e-4 of the largest of them
(f32 sums of up to a million terms). The bf16 inputs sit on a coarse grid,
so ties are common and the tie rules run (see the notes in ``csrc/``).

The 3x3 conv kernels sum their nine products in another order than the
plain version and round once: bf16 within 2^-7 of the largest output, f32
(split TF32: three tensor-core passes) within 1e-5 of it. The kernels (TMA
ring, wgmma) have two modes, chosen by shape: weights that stay in shared
memory and weights streamed with the input chunks; the shapes below cross
their tile edges (8, 16 and 64 pixels) and take both modes, and the f32
cases add the output chunks of 16 and 32 and a half-empty channel chunk.
"""

import numpy as np
import pytest
import torch

from cova_tpu_torch.ops.bn_pool import (
    _forward as bn_relu_pool_forward,
    bn_relu_pool_s2d,
    bn_relu_pool_s2d_backward,
    bn_relu_pool_s2d_backward_reference,
    bn_relu_pool_s2d_plain,
    bn_relu_pool_s2d_reference,
    fwd_plan,
)
from cova_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_plain,
    conv3x3_reference,
    conv3x3_roll,
    launch_plan,
)
from cova_tpu_torch.ops import _build
from cova_tpu_torch.ops.roi_pool import (
    roi_bounds,
    roi_bwd_plan,
    roi_pool,
    roi_pool_backward,
    roi_pool_backward_reference,
    roi_pool_bounds,
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
@pytest.mark.parametrize("out", [(3, 3), (2, 4), (1, 1)])
def test_roi_pool_bounds_kernel_equals_roi_bounds(cuda, out):
    """The bounds kernel that the RoIPool backward launches first, with
    boxes beyond the image, negative coordinates (roundf away from zero) and
    masked boxes."""
    rng = np.random.default_rng(sum(out))
    boxes, mask = _boxes(rng, 3, 50, 160)
    for m in (mask.to(cuda), None):
        args = (boxes.to(cuda), m, 0.25, *out, 40, 36)
        assert torch.equal(roi_pool_bounds(*args), roi_bounds(*args))


def test_kernel_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its source or a header of csrc/ changes,
    and only then."""
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1, 2), (2, 7, 15, 64),
                                   (1, 9, 17, 6), (2, 17, 33, 8),
                                   (1, 8, 1, 512)])
@pytest.mark.parametrize("offset_bytes", [0, 8])
def test_bn_relu_pool_kernel_ragged_and_unaligned(cuda, dtype, shape,
                                                  offset_bytes):
    """Maps of one s2d block, U and V across the 8 x 16 tile's edges, O
    of 2 and 6 (pairs of channels) and 512 (many chunks), from an aligned
    ys and from a view 8 bytes past a 16-byte boundary (pairs of channels by
    cp.async): bit-exact."""
    b, u, v, o = shape
    gen = torch.Generator(device=cuda).manual_seed(u * v + o)
    n = b * u * v * 4 * o
    off = offset_bytes // torch.empty((), dtype=dtype).element_size()
    flat = _tied(gen, (n + off,), dtype, cuda)
    ys = flat[off:].view(b, u, v, 4 * o)
    assert (ys.data_ptr() % 16 == 0) == (offset_bytes == 0)
    scale = torch.rand(o, generator=gen, device=cuda) + 0.5
    shift = torch.randn(o, generator=gen, device=cuda) * 0.5
    got = bn_relu_pool_s2d(ys, scale, shift)
    torch.cuda.synchronize()
    assert torch.equal(got, bn_relu_pool_s2d_reference(ys, scale, shift))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("knobs", [dict(stages=3),
                                   dict(stages=4, chunk_bytes=32),
                                   dict(blocks_per_sm=3, chunk_bytes=32),
                                   dict(chunk_bytes=128)],
                         ids=str)
def test_bn_relu_pool_kernel_plans(cuda, dtype, knobs):
    """The forward kernel under other plans than the default (deeper rings
    of stages, smaller and larger chunks, more blocks): bit-exact."""
    b, u, v, o = 2, 33, 50, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    ys = torch.randn(b, u, v, 4 * o, generator=gen, device=cuda).to(dtype)
    scale = torch.randn(o, generator=gen, device=cuda)
    shift = torch.randn(o, generator=gen, device=cuda)
    plan = fwd_plan(dtype, b, u, v, o, **knobs)
    got = bn_relu_pool_forward(ys, scale, shift, plan)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("knobs", [dict(cap=8, round_=4, chunk=3),
                                   dict(chunk=64, blocks_per_sm=8),
                                   dict(blocks_per_sm=1)],
                         ids=str)
def test_roi_pool_backward_kernel_plans(cuda, dtype, knobs):
    """The backward kernel under other plans: a pair list of 8 filled 4
    candidates at a time and staged 3 pairs at a time (every tile walks
    several lists and chunks), larger chunks and more blocks, one block per
    SM: bit-exact."""
    b, h, w, c, p = 2, 40, 36, 64, 50
    gen = torch.Generator(device=cuda).manual_seed(5)
    rng = np.random.default_rng(5)
    fm = _tied(gen, (b, h, w, c), dtype, cuda, levels=2.0)
    boxes, mask = _boxes(rng, b, p, 4 * max(h, w))
    boxes, mask = boxes.to(cuda), mask.to(cuda)
    pooled = roi_pool_reference(fm, boxes, mask, 0.25)
    g = torch.randn(pooled.shape, generator=gen, device=cuda).to(dtype)
    plan = roi_bwd_plan(dtype, b, p, h, w, c, 3, 3, **knobs)
    got = roi_pool_backward(fm, boxes, mask, pooled, g, 0.25, plan=plan)
    torch.cuda.synchronize()
    want = roi_pool_backward_reference(fm, boxes, mask, pooled, g, 0.25)
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
                                     ((1, 40, 31, 128), 128),
                                     ((1, 5, 1, 16), 16),
                                     ((3, 11, 7, 32), 64),
                                     ((1, 17, 63, 64), 64),
                                     ((2, 3, 64, 16), 32),
                                     ((1, 33, 65, 48), 64),
                                     ((1, 18, 129, 64), 16),
                                     ((3, 20, 24, 512), 512)])
def test_conv3x3_kernels_match_plain(cuda, dtype, shape, o):
    """Both schedules at ragged sizes (tiles cut at the right and bottom
    edges, C and O chunked, stationary and streamed weights), and dx
    through the kernel."""
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
    with pytest.raises(ValueError, match="multiple of 16"):
        conv3x3_roll(x.bfloat16(), torch.zeros(3, 3, 24, 16, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [conv3x3, conv3x3_roll])
def test_conv3x3_bf16_takes_views_and_f32_weights(cuda, fn):
    """A non-contiguous input and f32 weights (cast and transposed by the
    wrapper) give what the plain version gives on the same operands."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(2, 64, 19, 21, generator=gen, device=cuda).to(
        torch.bfloat16).permute(0, 2, 3, 1)  # an NCHW tensor seen as NHWC
    k = torch.randn(3, 3, 64, 64, generator=gen, device=cuda) * 0.06
    want = conv3x3_reference(x, k)
    got = fn(x, k)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -7 * float(
        want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [conv3x3, conv3x3_roll])
@pytest.mark.parametrize("shape,o,stationary,oc", [
    ((2, 9, 30, 64), 64, True, None),      # hi and lo of two chunks stay
    ((1, 33, 65, 48), 64, True, None),     # C = 48: channels 48..63 zero
    ((3, 11, 7, 32), 48, True, 16),        # W = 7; O = 48: K7 at OC = 16
    ((1, 17, 63, 160), 48, False, 16),     # streamed at OC = 16, W = 63
    ((1, 18, 65, 128), 128, False, None),  # streamed, W = 65
    ((2, 5, 64, 16), 32, True, None),      # C = 16: one half-empty chunk
])
def test_conv3x3_f32_split_tf32_plans(cuda, fn, shape, o, stationary, oc):
    """The split-TF32 kernels under each plan the f32 launch plan makes:
    weights kept or streamed, 16 or 32 output channels, the last channel
    chunk zero-filled by TMA; within 1e-5 of the largest output."""
    name = "conv3x3" if fn is conv3x3 else "conv3x3_roll"
    plan = launch_plan(name, torch.float32, *shape, o)
    assert plan.stationary == stationary
    assert oc is None or plan.oc == oc
    gen = torch.Generator(device=cuda).manual_seed(17)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda)
    k = torch.randn(3, 3, c, o, generator=gen, device=cuda) * (
        2.0 / (9 * c)) ** 0.5
    want = conv3x3_reference(x, k)
    got = fn(x, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [conv3x3, conv3x3_roll])
def test_conv3x3_f32_takes_views(cuda, fn):
    """A non-contiguous f32 input (an NCHW tensor seen as NHWC) gives what
    the plain version gives on the same operands."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    x = torch.randn(2, 48, 19, 21, generator=gen, device=cuda).permute(
        0, 2, 3, 1)
    k = torch.randn(3, 3, 48, 64, generator=gen, device=cuda) * 0.07
    want = conv3x3_reference(x, k)
    got = fn(x, k)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
