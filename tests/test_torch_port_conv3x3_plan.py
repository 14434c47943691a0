"""The launch plan and the schedule-following plain versions of the port's
bf16 3x3 conv kernels (``cova_tpu_torch/ops/conv3x3.py``), on the CPU.

The CUDA kernels run only on the card, so what can be checked here is their
index arithmetic: ``conv3x3_tiled_reference`` and
``conv3x3_roll_tiled_reference`` walk the tiles, boxes, taps, panels and
carries exactly as the kernels do, in plain PyTorch. In f32 they must equal
``conv3x3_reference`` within 1e-5 of the largest output (only the order of
the f32 sums differs) and the JAX package's Pallas kernels in interpret
mode within 1e-4 absolute (the tolerance of ``test_torch_port_conv3x3``).
The launch plan is held to its invariants over drawn shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cova_tpu.ops import conv3x3 as jconv
from cova_tpu_torch.ops import conv3x3 as pconv

# (B, H, W, C, O): widths on both sides of the tile edges of both kernels
# (8-pixel sub-tiles, 16-pixel tiles, 64-column strips tiles), heights that
# are no multiple of 2, 8 or 16, one and several channel chunks.
RAGGED = [
    (1, 3, 1, 16, 16),
    (2, 5, 7, 48, 16),
    (1, 17, 8, 16, 48),
    (1, 9, 9, 64, 64),
    (1, 2, 63, 16, 64),
    (1, 3, 64, 16, 16),
    (1, 4, 65, 48, 48),
    (1, 3, 129, 16, 16),
    (1, 18, 33, 128, 16),
    (2, 3, 5, 64, 128),
    (1, 2, 20, 128, 128),
]


def _operands(shape, seed=0):
    b, h, w, c, o = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, o)) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_schedules_match_reference_and_pallas(shape):
    x, k = _operands(shape)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    want = pconv.conv3x3_reference(xt, kt)
    tol = 1e-5 * float(want.abs().max())
    xj, kj = jnp.asarray(x), jnp.asarray(k)
    pallas = {
        "conv3x3": np.asarray(jconv.conv3x3(xj, kj, 32, True)),
        "conv3x3_roll": np.asarray(jconv.conv3x3_roll(xj, kj, 32, True)),
    }
    for name, fn in (("conv3x3", pconv.conv3x3_tiled_reference),
                     ("conv3x3_roll", pconv.conv3x3_roll_tiled_reference)):
        # 132 blocks (one tile each at these sizes) and 3 (every block walks
        # several work items, so carries and panels are reused).
        for n_sms in (132, 3):
            got = fn(xt, kt, n_sms)
            assert got.shape == want.shape and got.dtype == want.dtype
            assert not torch.isnan(got).any(), (name, n_sms)  # all stored
            assert float((got - want).abs().max()) <= tol, (name, n_sms)
            assert np.abs(got.numpy() - pallas[name]).max() <= 1e-4, name


@pytest.mark.parametrize("shape", [(1, 5, 70, 16, 32), (2, 19, 17, 80, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_schedules_round_once_in_bf16(shape):
    """bf16 operands, f32 sums and panels, one rounding."""
    x, k = _operands(shape, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    kt = torch.from_numpy(k)
    want = pconv.conv3x3_reference(xb, kt)
    top = float(want.float().abs().max())
    for fn in (pconv.conv3x3_tiled_reference,
               pconv.conv3x3_roll_tiled_reference):
        got = fn(xb, kt)
        assert got.dtype == torch.bfloat16
        assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -7 * top


channels = st.integers(1, 40).map(lambda n: 16 * n)
dims = st.tuples(st.integers(1, 4), st.integers(1, 70), st.integers(1, 140))


@settings(max_examples=60, deadline=None)
@given(kernel=st.sampled_from(pconv.KERNELS),
       dtype=st.sampled_from([torch.bfloat16, torch.float32]),
       bhw=dims, c=channels, o=channels)
def test_launch_plan_invariants(kernel, dtype, bhw, c, o):
    b, h, w = bhw
    p = pconv.launch_plan(kernel, dtype, b, h, w, c, o)
    assert p.smem_bytes <= pconv.SMEM_MAX
    assert p.kc % 16 == 0 and p.oc % 16 == 0
    assert c % p.kc == 0 and o % p.oc == 0
    assert (p.n_cc, p.n_oc) == (c // p.kc, o // p.oc)
    if dtype == torch.float32:
        assert p.stages == 1 and not p.stationary
        assert p.kc <= 32 and p.oc <= 64
        return
    # bf16: a chunk is one swizzle row of 64 channels at most; wgmma's N.
    assert p.kc * 2 <= pconv.SWIZZLE_ROW and p.oc in (16, 32, 64)
    assert p.stationary == (p.n_cc == 1)
    assert 2 <= p.stages <= pconv.MAX_STAGES
    # Every TMA destination and descriptor base lies on a swizzle atom: the
    # stationary weights, each stage, the stage's weights behind its input,
    # each tap's [oc, 64] matrix; a k-step moves a descriptor by 32 bytes.
    input_bytes = p.stage_bytes - (0 if p.stationary else p.weight_bytes)
    assert p.weight_bytes == 9 * p.oc * pconv.SWIZZLE_ROW
    for n in (p.weight_bytes, p.stage_bytes, input_bytes,
              p.oc * pconv.SWIZZLE_ROW):
        assert n % pconv.SWIZZLE_ATOM == 0
    assert input_bytes >= p.box[0] * p.box[1] * pconv.SWIZZLE_ROW
    assert (c * 2) % 16 == 0  # the tensor maps' strides
    fixed = p.smem_bytes - p.stages * p.stage_bytes
    assert fixed >= pconv.SWIZZLE_ATOM + (p.weight_bytes if p.stationary
                                          else 0)
    # One more stage would not fit.
    assert (p.stages == pconv.MAX_STAGES
            or p.smem_bytes + p.stage_bytes > pconv.SMEM_MAX)


@settings(max_examples=40, deadline=None)
@given(kernel=st.sampled_from(pconv.KERNELS),
       dtype=st.sampled_from([torch.bfloat16, torch.float32]),
       bhw=dims, c=channels, o=st.sampled_from([16, 48, 64, 96, 256]),
       n_sms=st.sampled_from([1, 3, 132]))
def test_tile_walk_covers_every_output_once(kernel, dtype, bhw, c, o, n_sms):
    b, h, w = bhw
    p = pconv.launch_plan(kernel, dtype, b, h, w, c, o)
    blocks = pconv.tile_walk(p, b, h, w, n_sms)
    if dtype == torch.bfloat16:
        assert len(blocks) <= max(n_sms, p.n_oc)
        for i, block in enumerate(blocks):  # a block keeps its output chunk
            assert {r[0] for r in block} <= {(i % p.n_oc) * p.oc}
    count = np.zeros((b, h, w, p.n_oc), np.int32)
    for block in blocks:
        for o0, bi, y0, y1, x0, x1 in block:
            assert 0 <= y0 <= y1 <= h and 0 <= x0 <= x1 <= w
            count[bi, y0:y1, x0:x1, o0 // p.oc] += 1
    assert (count == 1).all()


def test_chunk_choice_follows_the_mode():
    """Stationary weights with C in one chunk, streamed ones with more."""
    bf = torch.bfloat16
    flag = pconv.launch_plan("conv3x3", bf, 10, 320, 320, 64, 64)
    assert (flag.kc, flag.oc, flag.stationary, flag.stages) == (64, 64, True, 3)
    stem = pconv.launch_plan("conv3x3", bf, 10, 320, 320, 48, 256)
    assert (stem.kc, stem.oc, stem.n_oc, stem.stationary) == (48, 64, 4, True)
    deep = pconv.launch_plan("conv3x3", bf, 2, 20, 20, 512, 512)
    assert (deep.kc, deep.oc, deep.n_cc, deep.stationary) == (64, 32, 8, False)
    roll = pconv.launch_plan("conv3x3_roll", bf, 10, 320, 320, 64, 64)
    assert (roll.tile, roll.box, roll.stages) == ((2, 64), (4, 64), 2)


@pytest.mark.parametrize("kernel", pconv.KERNELS)
def test_launch_plan_refuses(kernel):
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="multiple of 16"):
        pconv.launch_plan(kernel, bf, 1, 8, 8, 24, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        pconv.launch_plan(kernel, torch.float32, 1, 8, 8, 16, 40)
    with pytest.raises(TypeError, match="unsupported dtype"):
        pconv.launch_plan(kernel, torch.float16, 1, 8, 8, 16, 16)
    with pytest.raises(ValueError, match="non-empty"):
        pconv.launch_plan(kernel, bf, 1, 0, 8, 16, 16)
    with pytest.raises(ValueError, match="B <= 65535"):
        pconv.launch_plan(kernel, torch.float32, 65536, 1, 1, 16, 16)
    with pytest.raises(ValueError, match="work items"):
        pconv.launch_plan(kernel, bf, 2 ** 20, 2 ** 16, 16, 16, 16)
    with pytest.raises(ValueError, match="no kernel"):
        pconv.launch_plan("conv5x5", bf, 1, 8, 8, 16, 16)
