"""The port's 3x3 conv (``cova_tpu_torch/ops/conv3x3.py``) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

The same numpy inputs go through ``cova_tpu.ops.conv3x3.conv3x3`` /
``conv3x3_roll`` (interpret mode, as ``tests/test_conv3x3.py`` runs them)
and ``conv3x3_reference`` there, and through the port's plain version, its
``conv3x3`` (the autograd function's CPU branch), ``conv3x3_roll`` and
``conv3x3_auto`` with the opt-in set. f32 values agree to 1e-4 absolute
(only the order of the sums differs); gradients to 1e-4 of their largest
entry; bf16 to 2^-7 of the largest output (one rounding of an f32 sum taken
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.ops import conv3x3 as jconv
from cova_tpu_torch.ops import conv3x3 as pconv
from cova_tpu_torch.ops.conv_stem import nhwc_conv2d

# (x shape, O, m_tile): tests/test_conv3x3.py's, plus the stem's channel
# widths and a map with H != W.
SHAPES = [
    ((1, 8, 8, 4), 8, 16),
    ((2, 12, 10, 8), 8, 16),
    ((1, 10, 10, 4), 4, 40),
    ((1, 6, 6, 48), 256, 32),
    ((2, 5, 11, 16), 32, 24),
]


def _operands(shape, o, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, shape[-1], o)) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape,o,m_tile", SHAPES)
def test_forward_matches_pallas_kernels(shape, o, m_tile, monkeypatch):
    x, k = _operands(shape, o)
    xj, kj = jnp.asarray(x), jnp.asarray(k)
    want = {
        "conv3x3": np.asarray(jconv.conv3x3(xj, kj, m_tile, True)),
        "conv3x3_roll": np.asarray(jconv.conv3x3_roll(xj, kj, m_tile, True)),
        "reference": np.asarray(jconv.conv3x3_reference(xj, kj)),
    }
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    monkeypatch.setenv("COVA_CUDA_CONV", "1")
    assert pconv.use_cuda_conv()
    got = {
        "reference": pconv.conv3x3_reference(xt, kt),
        "conv3x3": pconv.conv3x3(xt, kt),
        "conv3x3_roll": pconv.conv3x3_roll(xt, kt),
        "auto": pconv.conv3x3_auto(xt, kt),
    }
    for name, g in got.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == shape[:3] + (o,)
        for wname, w in want.items():
            assert np.abs(g.numpy() - w).max() <= 1e-4, (name, wname)


def test_auto_is_the_library_conv_unless_opted_in(monkeypatch):
    """Opt-in off: ``conv3x3_auto`` is ``F.conv2d`` bit for bit, and no
    launch is counted either way on the CPU."""
    x, k = _operands((2, 7, 9, 16), 32, seed=4)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    monkeypatch.delenv("COVA_CUDA_CONV", raising=False)
    assert not pconv.use_cuda_conv()
    lib = nhwc_conv2d(xt, kt.permute(3, 2, 0, 1), padding=1)
    assert torch.equal(pconv.conv3x3_auto(xt, kt), lib)
    monkeypatch.setenv("COVA_CUDA_CONV", "1")
    on = pconv.conv3x3_auto(xt, kt)
    assert not torch.equal(on, lib)  # another order of sums
    assert (on - lib).abs().max() <= 1e-5
    assert pconv.conv3x3.launches == 0 and pconv.conv3x3_roll.launches == 0


@pytest.mark.parametrize("shape,o,m_tile", [SHAPES[0], ((1, 8, 8, 4), 6, 16),
                                            SHAPES[4]])
def test_gradients_match_pallas_vjp(shape, o, m_tile):
    """dx (the kernel's function on the flipped, io-transposed weights) and
    dW (one library conv) of the port's autograd function against
    ``jax.grad`` through the interpret-mode ``conv3x3``."""
    x, k = _operands(shape, o, seed=2)
    g = np.random.default_rng(3).normal(size=shape[:3] + (o,)).astype(
        np.float32)

    def loss(xj, kj):
        return jnp.sum(jconv.conv3x3(xj, kj, m_tile, True) * g)

    dx_w, dk_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = pconv.conv3x3(xt, kt)
    assert y.grad_fn is not None and "_Conv3x3" in type(y.grad_fn).__name__
    dx, dk = torch.autograd.grad(y, (xt, kt), torch.from_numpy(g))
    for got, want in ((dx, dx_w), (dk, dk_w)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_input_gradient_is_skipped_for_an_image():
    """The stem's input needs no gradient: dW alone is computed."""
    x, k = _operands((1, 6, 6, 16), 16, seed=5)
    calls = []

    def fwd(a, b):
        calls.append(tuple(b.shape))
        return pconv.conv3x3_reference(a, b)

    kt = torch.from_numpy(k).requires_grad_()
    y = pconv._Conv3x3.apply(torch.from_numpy(x), kt, fwd)
    y.sum().backward()
    assert len(calls) == 1 and kt.grad is not None  # no dx product ran


@pytest.mark.parametrize("shape,o", [((2, 9, 12, 16), 32),
                                     ((1, 6, 6, 48), 256)])
def test_bf16_rounds_once(shape, o):
    """bf16 operands, f32 sums, one rounding: within 2^-7 of the largest
    output of the JAX package's bf16 conv, and of the f32 conv on the same
    bf16 values."""
    x, k = _operands(shape, o, seed=6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = pconv.conv3x3(xb, torch.from_numpy(k))  # w is cast to x.dtype
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jconv.conv3x3(xj, jnp.asarray(k), 32, True)
                      .astype(jnp.float32))
    exact = pconv.conv3x3_reference(
        xb.float(), torch.from_numpy(k).to(torch.bfloat16).float()).numpy()
    top = np.abs(exact).max()
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * top
    assert np.abs(got.float().numpy() - exact).max() <= 2.0 ** -7 * top


def test_chunk_choice_and_refused_shapes():
    """The channel chunks of the launch plan, and what the wrapper refuses
    before any launch (checked on the CPU: no kernel is reached)."""
    bf, f32 = torch.bfloat16, torch.float32
    plan = pconv.launch_plan
    assert plan("conv3x3", bf, 1, 8, 8, 48, 256).kc == 48
    assert plan("conv3x3", bf, 1, 8, 8, 512, 64).kc == 64
    assert plan("conv3x3", f32, 1, 8, 8, 48, 256).kc == 32
    assert plan("conv3x3", f32, 1, 8, 8, 48, 256).oc == 32
    assert plan("conv3x3_roll", f32, 1, 8, 8, 48, 256).oc == 16
    assert plan("conv3x3_roll", bf, 1, 8, 8, 64, 256).oc == 64
    assert plan("conv3x3_roll", bf, 1, 8, 8, 128, 256).oc == 32  # streamed
    with pytest.raises(ValueError, match="multiple of 16"):
        plan("conv3x3", bf, 1, 8, 8, 16, 24)
    x, k = _operands((1, 4, 4, 16), 16)
    with pytest.raises(ValueError, match="unsupported devices"):
        pconv._launch(torch.from_numpy(x), torch.from_numpy(k), "conv3x3")
