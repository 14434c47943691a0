"""The Swin trunk's LayerNorm with the residual add folded in
(``ops/layernorm.py``; K11, ``csrc/layernorm.cu``, on the card).

* On the CPU the wrapper is the trunk's old sequence bit for bit: ``x +
  res``, then the LayerNorm with its weight and bias cast to x's dtype, in
  bf16 and f32, with and without the residual and the sum.
* ``SwinStage1Backbone``, whose blocks now hand their MLP output on for the
  next LayerNorm to add, gives the old forward's output bit for bit in bf16
  and f32, and in f32 the same gradients.
* The card-side rules (bf16 only, 96 channels, contiguous 16-byte aligned
  maps, no gradient) raise on CPU tensors, before any launch.
* On the card (``cuda``): K11 against its plain version at the serving
  shape and at a token count off the kernel's tiles; the sum bit-equal to
  ``x + res``.
"""

import pytest
import torch
import torch.nn.functional as F

from cova_tpu_torch.models import swin
from cova_tpu_torch.ops import layernorm as k11

C = k11.CHANNELS
EPS = 1e-5


def _params(gen, c=C):
    """A LayerNorm's f32 weight and bias away from 1 and 0."""
    return (torch.rand(c, generator=gen) * 0.4 + 0.8,
            torch.rand(c, generator=gen) * 0.2 - 0.1)


def _old_norm(weight, bias, eps, x):
    """The trunk's LayerNorm before this wrapper (``models/swin.py
    _norm``)."""
    return F.layer_norm(x, (x.shape[-1],), weight.to(x.dtype),
                        bias.to(x.dtype), eps)


@pytest.mark.parametrize("sum_out", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_path_is_the_old_sequence(dtype, with_res, sum_out):
    gen = torch.Generator().manual_seed(11)
    x = (torch.randn(2, 5, 7, C, generator=gen) * 3 + 1).to(dtype)
    res = torch.randn(2, 5, 7, C, generator=gen).to(dtype) if with_res \
        else None
    w, b = _params(gen)
    got = k11.layernorm(x, w, b, EPS, res, sum_out=sum_out)
    s = x if res is None else x + res
    want = _old_norm(w, b, EPS, s)
    if sum_out:
        got, got_s = got
        assert got_s.dtype == dtype and torch.equal(got_s, s)
    assert got.dtype == dtype and torch.equal(got, want)


def _old_forward(trunk, x):
    """``SwinStage1Backbone.forward`` before the adds moved into the
    LayerNorms: each residual add, then each LayerNorm, on an s2d input."""
    def norm(ln, v):
        return _old_norm(ln.weight, ln.bias, ln.eps, v)

    pe = trunk.patch_embed
    w = pe.proj.weight.permute(0, 2, 3, 1).reshape(C, -1)
    x = norm(pe.norm, F.linear(x, w.to(x.dtype), pe.proj.bias.to(x.dtype)))
    for block in trunk.layers[0].blocks:
        attn = block.attn
        qkv = swin._linear(attn.qkv, norm(block.norm1, x))
        bias = swin.relative_bias(attn.relative_position_bias_table,
                                  attn.relative_position_index)
        a = swin.window_attention(qkv, bias, attn.qkv.bias.to(qkv.dtype),
                                  block.shift)
        x = x + swin._linear(attn.proj, a)
        h = F.gelu(swin._linear(block.mlp.fc1, norm(block.norm2, x)))
        x = x + swin._linear(block.mlp.fc2, h)
    return norm(trunk.norm0, x).contiguous()


def _trunk(gen):
    trunk = swin.SwinStage1Backbone()
    trunk.init_weights(gen)
    with torch.no_grad():
        for mod in trunk.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.copy_(torch.rand(C, generator=gen) * 0.4 + 0.8)
                mod.bias.copy_(torch.rand(C, generator=gen) * 0.2 - 0.1)
            elif isinstance(mod, swin.WindowAttention):
                mod.relative_position_bias_table.normal_(generator=gen)
    return trunk


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backbone_equals_the_old_forward(dtype):
    gen = torch.Generator().manual_seed(22)
    trunk = _trunk(gen)
    # A 9 x 11 token map: padded to 14 x 14, so the shift mask acts.
    x = torch.randn(2, 9, 11, 48, generator=gen).to(dtype)
    with torch.no_grad():
        got, want = trunk(x), _old_forward(trunk, x)
    assert got.dtype == dtype and torch.equal(got, want)


def test_backbone_gradients_equal_the_old_forward():
    gen = torch.Generator().manual_seed(33)
    trunk = _trunk(gen)
    x = torch.randn(1, 9, 11, 48, generator=gen)
    g = torch.randn(1, 9, 11, C, generator=gen)
    grads = []
    for fwd in (trunk, lambda v: _old_forward(trunk, v)):
        trunk.zero_grad(set_to_none=True)
        (fwd(x) * g).sum().backward()
        grads.append({k: p.grad.clone() for k, p in trunk.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def _misaligned(shape):
    """A contiguous bf16 map 2 bytes past a 16-byte boundary."""
    n = torch.Size(shape).numel()
    return torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)


FAULTS = {
    "f32": (TypeError, lambda: (torch.zeros(2, 3, C), None, False)),
    "f32_res": (TypeError, lambda: (torch.zeros(2, 3, C, dtype=torch.bfloat16),
                                    torch.zeros(2, 3, C), False)),
    "channels_64": (ValueError, lambda: (
        torch.zeros(2, 3, 64, dtype=torch.bfloat16), None, False)),
    "not_contiguous": (ValueError, lambda: (
        torch.zeros(3, 2, C, dtype=torch.bfloat16).transpose(0, 1), None,
        False)),
    "misaligned": (ValueError, lambda: (_misaligned((2, 3, C)), None, False)),
    "misaligned_res": (ValueError, lambda: (
        torch.zeros(2, 3, C, dtype=torch.bfloat16), _misaligned((2, 3, C)),
        False)),
    "res_shape": (ValueError, lambda: (
        torch.zeros(2, 3, C, dtype=torch.bfloat16),
        torch.zeros(3, 2, C, dtype=torch.bfloat16), False)),
    "requires_grad": (NotImplementedError, lambda: (
        torch.zeros(2, 3, C, dtype=torch.bfloat16), None, True)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_card_rules_refuse(fault):
    err, make = FAULTS[fault]
    x, res, grad = make()
    w, b = torch.ones(C), torch.zeros(C)
    if grad:
        w.requires_grad_()
    with pytest.raises(err):
        k11.check(x, w, b, res)


def test_card_rules_take_the_trunks_maps():
    x = torch.zeros(2, 3, 5, C, dtype=torch.bfloat16)
    k11.check(x, torch.ones(C), torch.zeros(C), x.clone())
    with torch.no_grad():  # a parameter is fine where no gradient is taken
        k11.check(x, torch.nn.LayerNorm(C).weight, torch.zeros(C))
    with pytest.raises(ValueError, match="weight"):
        k11.check(x, torch.ones(C + 1), torch.zeros(C))


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def bf16_step(top: float) -> float:
    """One bf16 step (2^-7 of the binade) at |value| ``top``: the most two
    roundings to bf16 of f32 numbers a few f32 steps apart can differ."""
    return 2.0 ** (torch.tensor(top).log2().floor().item() - 7)


# [2, 320, 320, 96]: 204,800 tokens, the serving map's tiles; [1, 13, 11,
# 96]: 143 tokens, off the kernel's 8-token warps and 64-token blocks.
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 320, 320, C), (1, 13, 11, C)])
@pytest.mark.parametrize("mode", ["plain", "res", "res_sum"])
def test_kernel_matches_plain(cuda, shape, mode):
    from cova_tpu_torch.ops import launches

    gen = torch.Generator(device=cuda).manual_seed(44)
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5).to(
        torch.bfloat16)
    res = None if mode == "plain" else torch.randn(
        shape, generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.rand(C, generator=gen, device=cuda) * 0.4 + 0.8
    b = torch.rand(C, generator=gen, device=cuda) * 0.2 - 0.1
    sum_out = mode == "res_sum"
    before = launches.counts()["layernorm"]
    got = k11.layernorm(x, w, b, EPS, res, sum_out=sum_out)
    want = k11.layernorm_plain(x, w, b, EPS, res, sum_out=sum_out)
    torch.cuda.synchronize()
    assert launches.counts()["layernorm"] == before + 1
    if sum_out:
        (got, got_s), (want, want_s) = got, want
        assert torch.equal(got_s.view(torch.int16), want_s.view(torch.int16))
    # Both round one f32 value to bf16; the f32 statistics differ only in
    # the order of their sums, so a value can land one bf16 step apart.
    top = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= bf16_step(top), (err, top)


@pytest.mark.cuda
def test_kernel_refuses_a_gradient(cuda):
    x = torch.randn(2, 8, C, device=cuda).to(torch.bfloat16).requires_grad_()
    w, b = torch.ones(C, device=cuda), torch.zeros(C, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        k11.layernorm(x, w, b, EPS)
