"""The launch plan and the schedule-following plain versions of the port's
3x3 conv kernels (``cova_tpu_torch/ops/conv3x3.py``), on the CPU.

The CUDA kernels run only on the card, so what can be checked here is their
index arithmetic: ``conv3x3_tiled_reference`` and
``conv3x3_roll_tiled_reference`` walk the tiles, boxes, taps, panels and
carries exactly as the kernels do, in plain PyTorch. In f32 they must equal
``conv3x3_reference`` within 1e-5 of the largest output (only the order of
the f32 sums differs) and the JAX package's Pallas kernels in interpret
mode within 1e-4 absolute (the tolerance of ``test_torch_port_conv3x3``).
The launch plan is held to its invariants over drawn shapes.

The f32 kernels run split TF32 (three tensor-core passes).
``conv3x3_split_tf32_reference`` repeats their operand rounding: it must
lie within 1e-5 of the largest output of ``conv3x3_reference`` and of the
JAX package's conv (the tolerance the card holds the f32 kernels to), and a
single TF32 pass must not.
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
    assert p.kc % 16 == 0 and p.oc % 16 == 0 and o % p.oc == 0
    assert p.n_oc == o // p.oc
    assert 2 <= p.stages <= pconv.MAX_STAGES
    # A chunk is one swizzle row; wgmma's N.
    if dtype == torch.float32:
        # 32 channels a chunk, the last zero-filled beyond C; hi and lo
        # weight planes; the weights stay wherever they fit beside two
        # stages.
        assert p.kc * 4 == pconv.SWIZZLE_ROW and p.planes == 2
        assert p.n_cc == -(-c // p.kc)
        assert p.oc in ((32, 16) if kernel == "conv3x3" else (16,))
        assert p.oc == (32 if kernel == "conv3x3" and o % 32 == 0 else 16)
        if not p.stationary:  # hi and lo of every chunk beside two stages
            panels_and_barriers = (p.smem_bytes - p.stages * p.stage_bytes
                                   - pconv.SWIZZLE_ATOM)
            halo = p.stage_bytes - 2 * p.weight_bytes
            assert (pconv.SWIZZLE_ATOM + panels_and_barriers
                    + 2 * p.n_cc * p.weight_bytes + 2 * halo
                    > pconv.SMEM_MAX)
    else:
        assert c % p.kc == 0 and p.n_cc == c // p.kc
        assert p.kc * 2 <= pconv.SWIZZLE_ROW and p.oc in (16, 32, 64)
        assert p.planes == 1 and p.stationary == (p.n_cc == 1)
    # Every TMA destination and descriptor base lies on a swizzle atom: the
    # stationary weights, each stage, the stage's weights behind its input,
    # each tap's [oc, 128-byte] matrix; a k-step moves a descriptor by 32
    # bytes.
    weights = p.planes * p.weight_bytes
    input_bytes = p.stage_bytes - (0 if p.stationary else weights)
    assert p.weight_bytes == 9 * p.oc * pconv.SWIZZLE_ROW
    for n in (p.weight_bytes, p.stage_bytes, input_bytes,
              p.oc * pconv.SWIZZLE_ROW):
        assert n % pconv.SWIZZLE_ATOM == 0
    assert input_bytes >= p.box[0] * p.box[1] * pconv.SWIZZLE_ROW
    assert (c * 2) % 16 == 0  # the tensor maps' strides
    fixed = p.smem_bytes - p.stages * p.stage_bytes
    assert fixed >= pconv.SWIZZLE_ATOM + (p.n_cc * weights if p.stationary
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
    with pytest.raises(ValueError, match="multiple of 16"):
        pconv.launch_plan(kernel, torch.float32, 1, 8, 8, 24, 16)
    with pytest.raises(TypeError, match="unsupported dtype"):
        pconv.launch_plan(kernel, torch.float16, 1, 8, 8, 16, 16)
    with pytest.raises(ValueError, match="non-empty"):
        pconv.launch_plan(kernel, bf, 1, 0, 8, 16, 16)
    with pytest.raises(ValueError, match="work items"):
        pconv.launch_plan(kernel, torch.float32, 2 ** 20, 2 ** 16, 16, 16,
                          16)
    with pytest.raises(ValueError, match="work items"):
        pconv.launch_plan(kernel, bf, 2 ** 20, 2 ** 16, 16, 16, 16)
    with pytest.raises(ValueError, match="no kernel"):
        pconv.launch_plan("conv5x5", bf, 1, 8, 8, 16, 16)


def test_f32_plan_follows_the_mode():
    """f32: hi and lo weights stay where they fit beside two stages (the
    model's C of 48 and 64), else they stream with the stages; K7 takes
    16 x 8 tiles and 32 output channels, K8 16."""
    f32 = torch.float32
    flag = pconv.launch_plan("conv3x3", f32, 10, 320, 320, 64, 64)
    assert (flag.kc, flag.oc, flag.n_cc, flag.stationary, flag.stages,
            flag.tile, flag.box) == (32, 32, 2, True, 3, (16, 8), (18, 10))
    # 2 planes x 2 chunks x 9 x 32 x 128 B, three 18 x 10 halos of 23,552 B.
    assert flag.smem_bytes == 1024 + 147_456 + 3 * 23_552 + 72 == 219_208
    stem = pconv.launch_plan("conv3x3", f32, 10, 320, 320, 48, 256)
    assert (stem.n_cc, stem.n_oc, stem.stationary) == (2, 8, True)
    deep = pconv.launch_plan("conv3x3", f32, 2, 20, 20, 512, 512)
    assert (deep.oc, deep.n_cc, deep.stationary, deep.stages) == (32, 16,
                                                                 False, 2)
    assert deep.stage_bytes == 23_552 + 2 * 36_864
    narrow = pconv.launch_plan("conv3x3", f32, 1, 9, 30, 160, 48)
    assert (narrow.oc, narrow.stationary) == (16, False)
    roll = pconv.launch_plan("conv3x3_roll", f32, 10, 320, 320, 64, 64)
    assert (roll.oc, roll.stationary, roll.stages, roll.smem_bytes) == (
        16, True, 4, 231_624)
    roll_deep = pconv.launch_plan("conv3x3_roll", f32, 1, 40, 31, 128, 128)
    assert (roll_deep.oc, roll_deep.stationary) == (16, False)


@pytest.mark.parametrize("c,o", [(16, 16), (48, 32), (64, 16), (96, 48)])
def test_tf32_weights_pair_with_the_fragment_columns(c, o):
    """The f32 kernels' A fragment of k-step s holds, in column k, channel
    2 KS (k % 4) + 2 s + k // 4 of the chunk (KS = 4 k-steps; 2 in a last
    chunk of 16 channels, whose k-steps 2 and 3 are not run): contiguous
    channels per thread. ``tf32_weights`` puts that channel's weights at
    position 8 s + k, so the chunk's product is x @ w. Checked on integers
    (exact)."""
    rng = np.random.default_rng(c + o)
    w = torch.from_numpy(rng.integers(-4, 5, (3, 3, c, o)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-4, 5, (64, c)).astype(np.float32))
    wk = pconv.tf32_weights(w)
    assert wk.shape == (3, 3, o, -(-c // 32) * 32)
    cols, pos = [], []  # x's channel and wk's position of every column run
    for c0 in range(0, c, 32):
        ks = min(32, c - c0) // 8
        for s in range(ks):
            for k in range(8):
                cols.append(c0 + 2 * ks * (k % 4) + 2 * s + k // 4)
                pos.append(c0 + 8 * s + k)
    assert sorted(cols) == list(range(c))
    a = x[:, cols]  # A as the kernel's fragments hold it
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(a @ wk[dy, dx][:, pos].T, x @ w[dy, dx])
    assert not wk[..., [q for q in range(wk.shape[-1]) if q not in pos]].any()


SPLIT_SHAPES = [(1, 6, 6, 48, 256), (2, 5, 11, 64, 64), (1, 7, 9, 16, 32),
                (1, 4, 13, 96, 48)]


def _scaled_operands(shape, seed):
    """x ~ N(0, 1), w at the model's he-normal scale, as the card's checks
    draw them."""
    b, h, w, c, o = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, o)) * (2.0 / (9 * c)) ** 0.5).astype(
        np.float32)
    return x, k


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_tf32_holds_the_f32_tolerance(shape):
    x, k = _scaled_operands(shape, seed=sum(shape))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    got = pconv.conv3x3_split_tf32_reference(xt, kt)
    assert got.dtype == torch.float32 and got.shape == shape[:3] + shape[4:]
    want = pconv.conv3x3_reference(xt, kt)
    jax_want = np.asarray(jconv.conv3x3(jnp.asarray(x), jnp.asarray(k), 32,
                                        True))
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top
    assert np.abs(got.numpy() - jax_want).max() <= 1e-5 * top


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_single_pass_tf32_misses_the_f32_tolerance(shape):
    """What the split is for: one TF32 pass (both operands rounded to
    nearest) is tens of times outside 1e-5 of the largest output."""
    x, k = _scaled_operands(shape, seed=sum(shape))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    want = pconv.conv3x3_reference(xt, kt)
    one = pconv.conv3x3_reference(pconv._tf32(xt, True),
                                  pconv._tf32(kt, True))
    assert float((one - want).abs().max()) > 1e-5 * float(want.abs().max())


def test_tf32_rounds_to_nearest_with_ties_away():
    """``_tf32`` keeps 10 mantissa bits: to nearest (ties away from zero,
    as ``cvt.rna``) or cut."""
    ulp = 2.0 ** -10
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 1 + ulp / 2 + 2.0 ** -20])
    assert pconv._tf32(v, True).tolist() == [1 + ulp, -(1 + ulp), 1.0,
                                             1 + ulp, 1 + ulp]
    assert pconv._tf32(v, False).tolist() == [1.0, -1.0, 1.0, 1.0, 1.0]
