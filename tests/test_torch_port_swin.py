"""The Swin-T trunk cut after stage 1 (``swin_t_stage1``: ``models/swin.py``,
``ops/window_attn.py``) against the benchmark's plain reference
(``benchmark/reference/trunks/swin_t_stage1.py``, the published code's
sequence in f32).

* The port's ``CoVA`` on the CPU, in f32, gives the reference's logits on
  the reference's seeded weights (``benchmark.weights.make_weights``, the
  bias tables at std 1.0) at 92^2 pixels: a 23 x 23 token map, padded to 28
  x 28, 4 x 4 windows, so the padding, the shift and the mask all act. Both
  sides compute in f32 and differ only in the order of their sums:
  ``logit_rel`` (a page's ||d logits|| / ||logits||) within LOGIT_REL.
* Four faults of the attention each fail that comparison: the relative
  index transposed, the shift rolled the wrong way, no shift mask, and
  zero keys for the pad tokens.
* K10's index plan (``window_plan``, the kernel's index arithmetic:
  gather by computed index, pad tokens' q, k and v from the qkv bias,
  scatter back) walked in PyTorch equals the pad -> roll -> partition
  version, for shift 0 and 3.
* The state_dict's names and shapes are the reference's, the published
  init holds, the trunk trains on the CPU, and the paths without a Swin
  counterpart (the JAX package, the pretrained registry) refuse it by name.
* On the card (``cuda``): K10 against its plain version at 1280^2, B = 2.
"""

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.reference import cova as reference
from benchmark.weights import make_weights
from cova_tpu_torch.config import BACKBONE_NAMES, BACKBONES, Config
from cova_tpu_torch.models import swin
from cova_tpu_torch.models.cova import CoVA, build_model
from cova_tpu_torch.ops import window_attn as wa

NAME = "swin_t_stage1"
# f32 on both sides, the same operations in another order: the port's
# logits are the reference's to ~1e-6; each fault below moves them by 1e-3
# (zero pad keys) to 4e-2.
LOGIT_REL = 1e-4
SEED = 2**31 + 21
CFG = dict(reference="benchmark/reference/cova.py", backbone=NAME,
           img_height=92, roi=3, hidden_dim=32, bbox_hidden_dim=8,
           context_size=3, n_classes=4, drop_prob=0.2,
           compute_dtype="float32", param_dtype="float32",
           learning_rate=5e-4, weight_decay=1e-3, max_boxes=24,
           box_buckets=[8, 16])


def _pages(n_pages=2, n_boxes=20, seed=5):
    rng = np.random.default_rng(seed)
    s = CFG["img_height"]
    pages = []
    for i in range(n_pages):
        xy = rng.integers(0, s - 8, (n_boxes, 2))
        wh = rng.integers(6, 48, (n_boxes, 2))
        wh = np.minimum(wh, s - xy)
        pages.append({
            "page_id": f"p{i}",
            "image": rng.integers(0, 256, (s, s, 3), dtype=np.uint8),
            "boxes_xywh": np.concatenate([xy, wh], 1).astype(np.float32),
            "labels": rng.integers(0, 4, n_boxes)})
    return pages


@pytest.fixture(scope="module")
def weights():
    return make_weights(CFG, SEED, "cpu")


@pytest.fixture(scope="module")
def pages():
    return _pages()


@pytest.fixture(scope="module")
def want(weights, pages):
    return reference.serve(weights, [pages], CFG, "cpu")[0]


def _port_logits(weights, pages):
    model = program.build_model(CFG, weights, "cpu")
    return program.serve(model, program.host_batch(pages, CFG)).numpy()


def _logit_rel(got, want, pages):
    rel = 0.0
    for i, pg in enumerate(pages):
        n = len(pg["labels"])
        d = got[i, :n].astype(np.float64) - want[i, :n]
        rel = max(rel, float(np.linalg.norm(d) / np.linalg.norm(want[i, :n])))
    return rel


def test_port_gives_the_reference_logits(weights, pages, want):
    got = _port_logits(weights, pages)
    assert got.shape == want.shape
    assert _logit_rel(got, want, pages) <= LOGIT_REL


def _rolled_the_wrong_way(qkv, bias, pad_qkv, shift):
    """``window_attention_plain`` with each roll's direction reversed."""
    b, h, w, _ = qkv.shape
    hp, wp = wa.padded_side(h), wa.padded_side(w)
    x = torch.nn.functional.pad(qkv.float(), (0, 0, 0, wp - w, 0, hp - h))
    real = (torch.arange(hp) < h)[:, None] & (torch.arange(wp) < w)[None, :]
    x = torch.where(real[None, :, :, None], x, pad_qkv.float())
    mask = None
    if shift:
        x = torch.roll(x, (shift, shift), (1, 2))
        mask = wa.shift_mask(hp, wp, shift)
    y = wa.attend(wa._partition(x, wa.WINDOW), bias, mask, bias.shape[0])
    y = wa._reverse(y, b, hp, wp, wa.WINDOW)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    return y[:, :h, :w].to(qkv.dtype)


def _zero_pad_keys(qkv, bias, pad_qkv, shift):
    c = pad_qkv.shape[0] // 3
    pad = pad_qkv.clone()
    pad[c:2 * c] = 0
    return wa.window_attention_plain(qkv, bias, pad, shift)


FAULTS = {
    "transposed_index": ("attention", lambda q, b, p, s:
                         wa.window_attention_plain(q, b.transpose(1, 2), p,
                                                   s)),
    "shift_reversed": ("attention", _rolled_the_wrong_way),
    "no_mask": ("mask", lambda hp, wp, shift, window=wa.WINDOW,
                mask=wa.shift_mask: torch.zeros_like(
                    mask(hp, wp, shift, window))),
    "pad_keys_zero": ("attention", _zero_pad_keys),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_fails_the_comparison(fault, weights, pages, want,
                                         monkeypatch):
    where, fn = FAULTS[fault]
    if where == "attention":
        monkeypatch.setattr(swin, "window_attention", fn)
    else:
        monkeypatch.setattr(wa, "shift_mask", fn)
    got = _port_logits(weights, pages)
    assert _logit_rel(got, want, pages) > 10 * LOGIT_REL


def window_plan(h, w, shift, window=wa.WINDOW):
    """K10's index arithmetic (``csrc/window_attn.cu`` ``token_index``,
    ``token_region``): ``(src, region)``, each [windows, n] int64, windows
    in the order of the kernel's blocks (row-major over the padded map).
    ``src``: the flat index ``y * w + x`` of the unpadded map's token that
    the window's token holds (position ``s`` of the rolled, padded map
    holds ``(s + shift) mod padded``), or -1 for a pad token; the kernel
    gathers q, k and v there (the bias for -1) and writes the output back
    there. ``region``: the token's shift region."""
    hp, wp = wa.padded_side(h, window), wa.padded_side(w, window)
    py = (torch.arange(hp) + shift) % hp
    px = (torch.arange(wp) + shift) % wp
    src = torch.where((py < h)[:, None] & (px < w)[None, :],
                      py[:, None] * w + px[None, :], -1)
    region = (wa._regions(hp, shift, window)[:, None] * 3
              + wa._regions(wp, shift, window)[None, :])
    part = wa._partition(torch.stack([src, region], -1)[None], window)
    return part[..., 0], part[..., 1]


def _plan_walk(qkv, bias, pad_qkv, shift):
    """K10's schedule in PyTorch: each window's tokens gathered by
    ``window_plan`` (pad tokens: the qkv bias), attended, scattered back
    to their own positions."""
    b, h, w, c3 = qkv.shape
    src, region = window_plan(h, w, shift)
    flat = torch.cat([qkv.reshape(b, h * w, c3),
                      pad_qkv.expand(b, 1, c3)], 1)
    windows = flat[:, torch.where(src >= 0, src, h * w)]
    mask = (torch.where(region[:, :, None] != region[:, None, :],
                        wa.MASK_VALUE, 0.0) if shift else None)
    n = src.shape[1]
    y = wa.attend(windows.reshape(-1, n, c3), bias, mask, bias.shape[0])
    y = y.reshape(b, -1, n, c3 // 3)
    out = torch.full((b, h * w, c3 // 3), float("nan"))
    real = src >= 0
    out[:, src[real]] = y[:, real]
    return out.reshape(b, h, w, -1)


@pytest.mark.parametrize("shape", [(2, 23, 23), (1, 9, 16), (1, 7, 14)])
@pytest.mark.parametrize("shift", [0, 3])
def test_kernel_index_plan_equals_pad_roll_partition(shape, shift):
    gen = torch.Generator().manual_seed(shift + sum(shape))
    b, h, w = shape
    qkv = torch.randn(b, h, w, 288, generator=gen)
    bias = torch.randn(3, 49, 49, generator=gen)
    pad = torch.randn(288, generator=gen)
    src, _ = window_plan(h, w, shift)
    real = src[src >= 0]
    assert sorted(real.tolist()) == list(range(h * w))  # each token once
    got = _plan_walk(qkv, bias, pad, shift)
    want = wa.window_attention_plain(qkv, bias, pad, shift)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_shift_mask_is_the_published_one():
    """Against the published construction, over a 28 x 28 padded map."""
    hp = wp = 28
    img = torch.zeros((1, hp, wp, 1))
    cnt = 0
    for hs in (slice(0, -7), slice(-7, -3), slice(-3, None)):
        for ws in (slice(0, -7), slice(-7, -3), slice(-3, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = wa._partition(img, 7)[..., 0]
    m = win.unsqueeze(1) - win.unsqueeze(2)
    m = m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)
    assert torch.equal(wa.shift_mask(hp, wp, 3), m)


def test_state_dict_is_the_references(weights):
    model = CoVA(hidden_dim=CFG["hidden_dim"],
                 bbox_hidden_dim=CFG["bbox_hidden_dim"], backbone=NAME)
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    want = [(k, tuple(s[0])) for k, s in reference.param_shapes(CFG).items()]
    assert got == want
    index = model.state_dict()[
        "convnet.layers.0.blocks.1.attn.relative_position_index"]
    assert index.dtype == torch.int64
    assert torch.equal(index, weights[
        "convnet.layers.0.blocks.1.attn.relative_position_index"])
    assert model.convnet.output_channels == 96
    assert model.gat.W_i.in_features == 96 * 9 + CFG["bbox_hidden_dim"]


def test_published_init():
    cfg = Config(img_height=64, backbone=NAME, hidden_dim=16,
                 bbox_hidden_dim=8, context_size=3)
    sd = build_model(cfg, "cpu").state_dict()
    tables = torch.cat([sd[f"convnet.layers.0.blocks.{i}.attn."
                           "relative_position_bias_table"].flatten()
                        for i in range(2)])
    assert 0.015 < float(tables.std()) < 0.025
    qkv = sd["convnet.layers.0.blocks.0.attn.qkv.weight"]
    assert 0.018 < float(qkv.std()) < 0.022
    for k, v in sd.items():
        if not k.startswith("convnet."):
            continue
        if ".norm" in k and k.endswith(".weight"):
            assert torch.equal(v, torch.ones_like(v)), k
        if k.endswith(".bias") and "patch_embed.proj" not in k:
            assert torch.equal(v, torch.zeros_like(v)), k
    assert float(sd["convnet.patch_embed.proj.weight"].abs().max()) \
        <= 48 ** -0.5
    # Only the trunk takes the published init: the head keeps the JAX
    # package's U(+-1/sqrt(fan_in)) biases.
    assert float(sd["decoder.1.bias"].abs().max()) > 0


def test_trunk_trains_on_the_cpu():
    cfg = Config(img_height=64, backbone=NAME, hidden_dim=16,
                 bbox_hidden_dim=8, context_size=3, compute_dtype="float32")
    model = build_model(cfg, "cpu").train()
    x = torch.randint(0, 256, (2, 16, 16, 48), dtype=torch.uint8)
    boxes = torch.tensor([[[0., 0., 30., 30.], [20., 10., 60., 50.]]] * 2)
    mask = torch.ones(2, 2, dtype=torch.bool)
    ctx = torch.tensor([[[1, -1, -1, -1, -1, -1], [0, -1, -1, -1, -1, -1]]]
                       * 2, dtype=torch.int32)
    out = model(x, boxes, mask, ctx, generator=torch.Generator())
    out.logits.sum().backward()
    table = model.convnet.layers[0].blocks[1].attn.relative_position_bias_table
    assert table.grad is not None and torch.isfinite(table.grad).all()
    assert float(table.grad.abs().sum()) > 0


def test_names_outside_the_resnet_registry():
    assert NAME in BACKBONE_NAMES and NAME not in BACKBONES
    import argparse

    from cova_tpu_torch.cli import _add_common_flags

    parser = argparse.ArgumentParser()
    _add_common_flags(parser)
    assert parser.parse_args(["--backbone", NAME]).backbone == NAME
    trunk = CoVA(backbone=NAME).convnet
    assert Config(backbone=NAME).backbone_channels == trunk.output_channels
    assert Config(backbone=NAME).feature_stride == trunk.output_stride == 4


def test_paths_without_a_swin_counterpart_refuse_it_by_name():
    from cova_tpu_torch.utils import pretrained
    from cova_tpu_torch.utils.weights import state_dict_from_jax

    with pytest.raises(ValueError, match="JAX package has no backbone"):
        state_dict_from_jax({"convnet": {}}, {"convnet": {}},
                            Config(backbone=NAME))
    for call in (lambda: pretrained.resolve_checkpoint(NAME),
                 lambda: pretrained.load_verified_backbone(NAME, "x.pth"),
                 lambda: pretrained.backbone_state_dict(NAME, {})):
        with pytest.raises(ValueError, match="no released checkpoint"):
            call()


# -- on the card -----------------------------------------------------------

# K10 against its plain version: the kernel rounds P to bf16 before P v
# and its output to bf16 (2^-9 each), where the plain version stays f32;
# the largest gap within 2^-6 of the largest output.
K10_TOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3])
def test_kernel_matches_plain_at_1280(cuda, shift):
    from cova_tpu_torch.ops import launches

    gen = torch.Generator(device=cuda).manual_seed(7 + shift)
    qkv = torch.randn(2, 320, 320, 288, generator=gen, device=cuda).to(
        torch.bfloat16)
    bias = wa.relative_bias(torch.randn(169, 3, generator=gen, device=cuda),
                            wa.relative_position_index().to(cuda))
    pad = torch.randn(288, generator=gen, device=cuda).to(torch.bfloat16)
    before = launches.counts()["window_attn"]
    got = wa.window_attention(qkv, bias, pad, shift).float()
    want = wa.window_attention_plain(qkv, bias, pad, shift).float()
    torch.cuda.synchronize()
    assert launches.counts()["window_attn"] == before + 1
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= K10_TOL, err
    with pytest.raises(NotImplementedError, match="no backward"):
        wa.window_attention(qkv.float().requires_grad_().bfloat16(), bias,
                            pad, shift)
