"""K9 (``ops/bn_act.py``, ``csrc/bn_act.cu``): eval-mode BatchNorm affine,
residual and ReLU in one pass, and the trunk's blocks that use it.

On the CPU: ``bn_act_plain`` equals the modules' composition bit for bit
(``MaskedBatchNorm``'s eval forward, the residual add, ``F.relu``); an
eval-mode ``BasicBlock`` and ``Bottleneck`` give the old expressions' bits;
in training mode the blocks run the modules one by one as before, gradients
flow and K9 never launches; the launch plan's walk visits every element
once. The tests marked ``cuda`` hold the kernel to ``bn_act_plain`` bit for
bit on the card (layer1 shapes of ResNet-18 and ResNet-50, NaN, +-0 and
+-inf planted, an unaligned view, a channel count that is not a multiple
of 8) and count its launches through a graphed ``forward_step``. This file
imports neither JAX nor ``cova_tpu``.
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cova_tpu_torch.config import Config
from cova_tpu_torch.data.pipeline import make_pipelines
from cova_tpu_torch.data.synthetic import InMemoryWebDataset
from cova_tpu_torch.models import resnet
from cova_tpu_torch.models.cova import build_model
from cova_tpu_torch.models.layers import MaskedBatchNorm
from cova_tpu_torch.models.resnet import BasicBlock, Bottleneck
from cova_tpu_torch.ops import bn_act as bn_act_mod
from cova_tpu_torch.ops import launches
from cova_tpu_torch.ops.bn_act import Plan, bn_act, bn_act_plain, launch_plan
from cova_tpu_torch.ops.conv_stem import nhwc_conv2d
from cova_tpu_torch.train import steps

DTYPES = [torch.bfloat16, torch.float32]
RES = ["none", "identity", "bn"]
CHANNELS = [64, 256, 20]


def _randomize_bn(bn: MaskedBatchNorm, gen: torch.Generator) -> None:
    with torch.no_grad():
        f = bn.features
        bn.weight.copy_(torch.rand(f, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(f, generator=gen))
        bn.running_mean.copy_(torch.randn(f, generator=gen))
        bn.running_var.copy_(torch.rand(f, generator=gen) + 0.25)


def _special(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``x`` with NaN, +-inf and +-0 planted at random places."""
    flat = x.reshape(-1).clone()
    vals = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0,
                         -0.0], dtype=x.dtype)
    idx = torch.randint(0, flat.numel(), (5 * 16,), generator=gen)
    flat[idx] = vals.repeat(16)
    return flat.reshape(x.shape)


def _operands(c, dtype, res_kind, seed, shape=(2, 5, 7)):
    gen = torch.Generator().manual_seed(seed)
    bn, rbn = MaskedBatchNorm(c).eval(), MaskedBatchNorm(c).eval()
    _randomize_bn(bn, gen)
    _randomize_bn(rbn, gen)
    x = _special(torch.randn(*shape, c, generator=gen).to(dtype), gen)
    res = None if res_kind == "none" else _special(
        torch.randn(*shape, c, generator=gen).to(dtype), gen)
    return bn, rbn, x, res


def _composition(bn, rbn, x, res, res_kind, relu):
    """What the blocks computed before K9: the modules one by one."""
    y = bn(x)
    if res_kind != "none":
        y = y + (res if res_kind == "identity" else rbn(res))
    return F.relu(y) if relu else y


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("res_kind", RES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_act_plain_equals_the_module_composition(dtype, relu, res_kind,
                                                     c):
    bn, rbn, x, res = _operands(c, dtype, res_kind, seed=c)
    scale, shift = bn(x, return_coefficients=True)
    rs, rh = rbn(x, return_coefficients=True) if res_kind == "bn" else (
        None, None)
    want = _composition(bn, rbn, x, res, res_kind, relu)
    for fn in (bn_act_plain, bn_act):
        got = fn(x, scale, shift, relu=relu, res=res, res_scale=rs,
                 res_shift=rh)
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(_bits(got), _bits(want))


def _old_forward(block, x):
    """The blocks' forward before K9 (parent commit), for comparison."""
    def residual():
        if block.downsample is None:
            return x
        conv, bn = block.downsample[0], block.downsample[1]
        return bn(nhwc_conv2d(x, conv.weight, stride=block.stride))

    if isinstance(block, BasicBlock):
        if block.stride == 1:
            y = resnet.conv3x3_auto(x, resnet._hwio(block.conv1))
        else:
            y = nhwc_conv2d(x, block.conv1.weight, stride=block.stride,
                            padding=1)
        y = F.relu(block.bn1(y))
        y = block.bn2(resnet.conv3x3_auto(y, resnet._hwio(block.conv2)))
        return F.relu(y + residual())
    y = F.relu(block.bn1(nhwc_conv2d(x, block.conv1.weight)))
    y = nhwc_conv2d(y, block.conv2.weight, stride=block.stride, padding=1)
    y = F.relu(block.bn2(y))
    y = block.bn3(nhwc_conv2d(y, block.conv3.weight))
    return F.relu(y + residual())


BLOCKS = {
    "basic": lambda: BasicBlock(64, 64),
    "basic_downsample": lambda: BasicBlock(64, 128, stride=2),
    "bottleneck_downsample": lambda: Bottleneck(64, 64),
    "bottleneck": lambda: Bottleneck(256, 64),
}


def _block(kind, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    block = BLOCKS[kind]()
    with torch.no_grad():
        for p in block.parameters():
            if p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (2.0 / p[0].numel()) ** 0.5)
    for m in block.modules():
        if isinstance(m, MaskedBatchNorm):
            _randomize_bn(m, gen)
    inplanes = block.conv1.in_channels
    x = torch.randn(2, 12, 10, inplanes, generator=gen).to(dtype)
    return block, x


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("kind", list(BLOCKS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_blocks_equal_the_old_expressions(dtype, kind, grad):
    """Bit for bit; with grad on (an input that requires it) the plain
    path runs and its input gradient is the old one's too."""
    block, x = _block(kind, dtype)
    block.eval()
    old = copy.deepcopy(block)
    launches.zero()
    with torch.set_grad_enabled(grad):
        xa, xb = x.clone().requires_grad_(grad), x.clone().requires_grad_(grad)
        got, want = block(xa), _old_forward(old, xb)
        assert torch.equal(_bits(got), _bits(want))
        if grad:
            g = torch.randn(got.shape, generator=torch.Generator()
                            .manual_seed(1)).to(dtype)
            got.backward(g)
            want.backward(g)
            assert torch.equal(xa.grad, xb.grad)
    assert launches.counts()["bn_act"] == 0  # the CPU runs the plain version


@pytest.mark.parametrize("kind", list(BLOCKS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_training_blocks_run_the_modules_and_never_launch(dtype, kind):
    block, x = _block(kind, dtype, seed=1)
    block.train()
    old = copy.deepcopy(block)
    launches.zero()
    with mock.patch.object(resnet, "bn_act",
                           side_effect=AssertionError("bn_act in training")):
        got = block(x.clone().requires_grad_(True))
    want = _old_forward(old, x.clone().requires_grad_(True))
    assert torch.equal(_bits(got), _bits(want))
    got.float().square().sum().backward()
    want.float().square().sum().backward()
    for (name, p), q in zip(block.named_parameters(), old.parameters()):
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert torch.equal(p.grad, q.grad), name
    for a, b in zip(block.buffers(), old.buffers()):
        assert torch.equal(a, b)  # the same running-statistics update
    assert launches.counts()["bn_act"] == 0


def _walk(numel: int, c: int, plan: Plan):
    """The kernel's walk (``bn_act_kernel`` in ``csrc/bn_act.cu``) as index
    arithmetic: for each walking thread, its channel vector and the element
    offsets it visits."""
    groups = c // plan.vec
    walkers = plan.blocks * bn_act_mod.THREADS // groups * groups
    n_vec = numel // plan.vec
    for t in range(walkers):
        yield (t % groups) * plan.vec, range(t * plan.vec, n_vec * plan.vec,
                                             walkers * plan.vec)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", [64, 256, 20, 2048])
def test_launch_plan_walk_visits_each_element_once(c, aligned):
    numel = c * 37
    plan = launch_plan(numel, c, aligned)
    assert plan.vec == (8 if aligned and c % 8 == 0 else 1)
    assert plan.blocks * bn_act_mod.THREADS >= c // plan.vec
    seen = np.zeros(numel, np.int64)
    for c0, starts in _walk(numel, c, plan):
        for s in starts:
            assert s % c == c0
            seen[s:s + plan.vec] += 1
    assert (seen == 1).all()
    # The flagship maps fill the card: BLOCKS_PER_SM blocks on each SM.
    big = launch_plan(10 * 320 * 320 * 256, 256, aligned=True)
    assert big == Plan(8, bn_act_mod.BLOCKS_PER_SM * bn_act_mod.N_SMS)


def test_bn_act_rejects_what_it_does_not_take():
    x = torch.zeros(2, 3, 8)
    s = torch.ones(8)
    with pytest.raises(ValueError):
        bn_act_mod._check(x, torch.ones(4), s, None, None, None)
    with pytest.raises(ValueError):
        bn_act_mod._check(x, s, s, torch.zeros(2, 3, 4), None, None)
    with pytest.raises(ValueError):
        bn_act_mod._check(x, s, s, None, s, s)
    with pytest.raises(ValueError):
        bn_act_mod._check(x.transpose(0, 1), s, s, None, None, None)
    with pytest.raises(TypeError):
        bn_act_mod._check(x.half(), s, s, None, None, None)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ResNet-18's and ResNet-50's layer1 maps at B = 10, 1280^2; then small
# maps: channels a multiple of 8, and 20 (the scalar walk).
CARD_SHAPES = [(10, 320, 320, 64), (10, 320, 320, 256), (2, 33, 35, 24),
               (3, 17, 19, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("res_kind", RES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_equals_plain_bit_for_bit(cuda, shape, dtype, res_kind, relu):
    c = shape[-1]
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    numel = int(np.prod(shape))

    def special(t):
        idx = torch.randint(0, t.numel(), (4096,), generator=gen,
                            device=cuda)
        vals = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0,
                             -0.0], device=cuda, dtype=t.dtype)
        t.view(-1)[idx] = vals.repeat(1024)[:4096]
        return t

    def coef(plant):
        s = torch.rand(c, generator=gen, device=cuda) + 0.5
        h = torch.randn(c, generator=gen, device=cuda)
        if plant:  # 0 * inf = NaN; -0 + -0 = -0, whose ReLU is PyTorch's
            s[0], h[1], h[2] = 0.0, -0.0, 0.0
        return s, h

    scale, shift = coef(True)
    rs, rh = coef(True) if res_kind == "bn" else (None, None)
    for offset in (0, 1):  # 1: a view one element past the allocation
        buf = torch.randn(numel + offset, generator=gen, device=cuda)
        x = special(buf.to(dtype)[offset:].view(shape))
        res = None
        if res_kind != "none":
            rbuf = torch.randn(numel + offset, generator=gen, device=cuda)
            res = special(rbuf.to(dtype)[offset:].view(shape))
        before = bn_act.launches
        with torch.inference_mode():
            got = bn_act(x, scale, shift, relu=relu, res=res, res_scale=rs,
                         res_shift=rh)
        torch.cuda.synchronize()
        assert bn_act.launches == before + 1
        want = bn_act_plain(x, scale, shift, relu=relu, res=res,
                            res_scale=rs, res_shift=rh)
        assert torch.equal(_bits(got), _bits(want)), (shape, offset)
        del x, res, got, want, buf


def _serve_batch(cfg, b=2):
    ds = InMemoryWebDataset(8, cfg.img_height, seed=0, min_boxes=4,
                            max_boxes=cfg.max_boxes)
    _, _, test = make_pipelines(cfg, ds, ds, ds)
    it = test.epoch(0)
    batch = next(it)[1]
    it.close()
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("backbone,per_batch",
                         [("resnet18_stem", 4), ("resnet50_stem", 9)])
def test_graphed_forward_launches_k9_and_equals_plain(cuda, backbone,
                                                       per_batch):
    """A graphed ``forward_step`` of the benchmark's two trunks: 4 (two
    BasicBlocks) and 9 (three Bottlenecks) K9 launches a batch through its
    eager run, its capture and its replays, and the plain path's logits bit
    for bit."""
    cfg = Config(img_height=512, backbone=backbone, compute_dtype="bfloat16",
                 eval_batch_size=4)
    model = build_model(cfg, device=cuda)
    gen = torch.Generator().manual_seed(2)
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            _randomize_bn(m, gen)
    batch = _serve_batch(cfg)
    with mock.patch.object(resnet, "bn_act", bn_act_plain):
        before = launches.counts()
        want = steps.forward_step(model, batch, graphs=False)
        assert launches.since(before)["bn_act"] == 0
    for _ in range(4):  # eager, capture + replay, replay, replay
        before = launches.counts()
        got = steps.forward_step(model, batch)
        torch.cuda.synchronize()
        assert launches.since(before)["bn_act"] == per_batch
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.attn_wts, want.attn_wts)
