"""Every backbone of the registry, in the port and in the JAX package, on
the CPU at a small size (64^2 screenshots, B = 2, f32).

A seeded Flax init with perturbed BN statistics and affines is carried
across by ``state_dict_from_jax``; the backbone alone and the whole ``CoVA``
forward are then compared in eval mode and in train mode (batch statistics,
and the running statistics the forward leaves behind). One train step's
gradients are compared for a BasicBlock backbone with strided and
projection blocks (``resnet18``) and a Bottleneck one (``resnet50_stem``).

Tolerance: 1e-4 absolute and relative in f32 for the stem variants. The
full backbones end on a 2x2 map, where train-mode BN normalizes 8 values
per channel and divides by a small standard deviation, so differences in
the order of f32 sums are amplified layer after layer: they are held to
1e-3 of the output's largest value instead, as stated at each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cova_tpu.config import Config as JaxConfig
from cova_tpu.data.pipeline import DataPipeline
from cova_tpu.data.synthetic import InMemoryWebDataset
from cova_tpu.models.cova import build_model as jax_build_model
from cova_tpu.models.resnet import make_backbone as jax_make_backbone
from cova_tpu.train import steps as jax_steps
from cova_tpu_torch.config import Config
from cova_tpu_torch.data.batching import Batch
from cova_tpu_torch.models.cova import build_model
from cova_tpu_torch.models.resnet import BACKBONES, make_backbone
from cova_tpu_torch.train.steps import (
    batch_to_device,
    forward_step,
    masked_ce_sum,
)
from cova_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(img_height=64, max_boxes=24, context_size=3, hidden_dim=32,
             bbox_hidden_dim=8, batch_size=2, eval_batch_size=2,
             compute_dtype="float32", drop_prob=0.0)
FULL = ("resnet18", "resnet50")


def _roi(name):
    """RoI bins per side: 1 for ``resnet50``, whose 2048 channels at 3x3
    bins would make the decoder an 18k x 18k matrix."""
    return 1 if name == "resnet50" else 3


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "var":
            v = rng.uniform(0.5, 2.0, v.shape)
        elif k == "mean":
            v = rng.normal(0.0, 0.2, v.shape)
        elif k == "scale":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "bias":
            v = rng.normal(0.0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _case(name, seed=0):
    """(port config, JAX train state, params, stats, batch) for backbone
    ``name``, from ``seed``."""
    kw = dict(SMALL, backbone=name, roi=_roi(name))
    jcfg = JaxConfig(**kw)
    ds = InMemoryWebDataset(2, 64, seed=seed, min_boxes=4, max_boxes=24)
    pipe = DataPipeline(ds, batch_size=2, pad_boxes=jcfg.pad_boxes,
                        context_size=3, num_threads=1)
    _, batch = next(iter(pipe.epoch(0)))
    batch = Batch(*batch)
    model = jax_build_model(jcfg)
    state = jax_steps.create_train_state(model, jcfg, batch,
                                         jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = _perturb(jax.device_get(state.params), rng)
    stats = _perturb(jax.device_get(state.batch_stats), rng)
    state = state.replace(params=params, batch_stats=stats)
    return Config(**kw), state, params, stats, batch


@pytest.fixture(scope="module", params=BACKBONES)
def case(request):
    return (request.param, *_case(request.param))


def _port(cfg, params, stats):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats, cfg),
                          strict=True)
    return model


def _tol(name, want):
    """(rtol, atol): see the module docstring."""
    if name in FULL:
        return 1e-3, 1e-3 * float(np.abs(want).max())
    return 1e-4, 1e-4


def test_registry_matches_jax_package():
    for name in BACKBONES:
        jb, pb = jax_make_backbone(name), make_backbone(name)
        assert pb.output_stride == jb.output_stride
        assert pb.output_channels == jb.output_channels
        cfg = Config(backbone=name)
        assert cfg.feature_stride == pb.output_stride
        assert cfg.backbone_channels == pb.output_channels
    with pytest.raises(ValueError, match="unknown backbone"):
        make_backbone("resnet101")


def test_backbone_forward_matches_jax(case):
    """The backbone alone, eval mode, on the batch's s2d(4) images."""
    name, cfg, _, params, stats, batch = case
    x = batch.images.astype(np.float32) / 255.0
    want = np.asarray(jax_make_backbone(name).apply(
        {"params": params["convnet"], "batch_stats": stats["convnet"]},
        jnp.asarray(x), train=False))
    model = _port(cfg, params, stats)
    with torch.no_grad():
        got = model.convnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    rtol, atol = _tol(name, want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_cova_eval_forward_matches_jax(case):
    name, cfg, state, params, stats, batch = case
    want = jax.device_get(jax_steps._apply(state, params, batch,
                                           train=False))
    out = forward_step(_port(cfg, params, stats), batch)
    mask = batch.box_mask
    w = np.asarray(want.logits)[mask]
    rtol, atol = _tol(name, w)
    np.testing.assert_allclose(out.logits.numpy()[mask], w, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(out.attn_wts.numpy()[mask],
                               np.asarray(want.attn_wts)[mask], rtol=rtol,
                               atol=max(atol, 1e-4))


def test_cova_train_forward_matches_jax(case):
    """Train mode: logits from the batch statistics, and every running
    statistic after the forward."""
    name, cfg, state, params, stats, batch = case
    want, new_vars = jax.device_get(jax_steps._apply(
        state, params, batch, train=True, rng=jax.random.PRNGKey(0)))
    model = _port(cfg, params, stats).train()
    with torch.no_grad():
        out = model(**batch_to_device(batch, "cpu"))
    mask = batch.box_mask
    w = np.asarray(want.logits)[mask]
    rtol, atol = _tol(name, w)
    np.testing.assert_allclose(out.logits.numpy()[mask], w, rtol=rtol,
                               atol=atol)
    want_sd = state_dict_from_jax(params, new_vars["batch_stats"], cfg)
    got_sd = model.state_dict()
    n = 0
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            rt, at = _tol(name, v.numpy())
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=rt, atol=at, err_msg=k)
            n += 1
    assert n >= 2 * 7


@pytest.mark.parametrize("name", ["resnet18", "resnet50_stem"])
def test_train_step_gradients_match_jax(name):
    """One training forward and backward from the same weights: every
    parameter's gradient against ``jax.grad`` of the JAX loss, at
    ``tests/test_torch_port_train.py``'s tolerance (rtol 1e-4, atol 1e-5 of
    the tensor's largest gradient plus 1e-6), which the full ``resnet18``
    widens tenfold for the reason in the module docstring.

    The comparison needs a point where the loss is smooth. At seed 0 it is
    not: scaling the port's own weights by 1 + 1e-7 of noise there moves
    its ``resnet50_stem`` gradients by up to 6% (a ReLU or a pooled maximum
    changes hands), and the two frameworks differ by exactly that. Seed 2
    has no such kink for either backbone."""
    cfg, state, params, stats, batch = _case(name, seed=2)

    def loss(p):
        out, _ = jax_steps._apply(state, p, batch, train=True,
                                  rng=jax.random.PRNGKey(0))
        return jax_steps.masked_ce_sum(out.logits, batch.labels,
                                       batch.box_mask)

    want = state_dict_from_jax(jax.device_get(jax.grad(loss)(params)),
                               stats, cfg)
    model = _port(cfg, params, stats).train()
    out = model(**batch_to_device(batch, "cpu"))
    masked_ce_sum(out.logits, torch.from_numpy(batch.labels),
                  torch.from_numpy(batch.box_mask)).backward()
    wide = 10.0 if name in FULL else 1.0
    n = 0
    for k, p in model.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=1e-4 * wide,
            atol=(1e-5 * float(np.abs(w).max()) + 1e-6) * wide, err_msg=k)
        n += 1
    assert n > 40


@pytest.mark.parametrize("name", BACKBONES)
def test_conv_opt_in_on_the_cpu_equals_the_default(name, monkeypatch):
    """``COVA_CUDA_CONV=1`` on the CPU runs the plain nine-product conv in
    place of ``F.conv2d``: the same logits within 1e-5 (of the largest, for
    the full backbones)."""
    cfg, _, params, stats, batch = _case(name)
    model = _port(cfg, params, stats)
    monkeypatch.delenv("COVA_CUDA_CONV", raising=False)
    off = forward_step(model, batch).logits.numpy()
    monkeypatch.setenv("COVA_CUDA_CONV", "1")
    on = forward_step(model, batch).logits.numpy()
    mask = batch.box_mask
    scale = max(1.0, float(np.abs(off[mask]).max())) if name in FULL else 1.0
    assert np.abs(on - off)[mask].max() <= 1e-5 * scale
    if name != "resnet50_stem" and name != "resnet50":
        assert not np.array_equal(on, off)  # the other conv really ran


@pytest.mark.parametrize("name", BACKBONES)
def test_cli_trains_evaluates_and_serves_every_backbone(name, tmp_path,
                                                        monkeypatch):
    """``cli train``, ``eval`` and ``predict`` with ``--backbone``, on the
    CPU at a small size: finite epoch losses, the reports, and one CSV per
    served page from the fold's checkpoint."""
    import os

    from cova_tpu_torch.cli import main

    flags = ["--synthetic", "10", "--img_height", "64", "-cs", "3", "-hd",
             "32", "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2",
             "--device", "cpu", "--backbone", name, "-r", str(_roi(name)),
             "--output_dir", str(tmp_path / "out")]
    assert main(["train", *flags, "-e", "1"]) == 0
    res = tmp_path / "out" / Config().replace(
        context_size=3, hidden_dim=32, bbox_hidden_dim=8,
        roi=_roi(name)).params_key
    with open(res / "Fold-1 logs.txt") as f:
        losses = [float(line.split("Loss:")[1].split()[0])
                  for line in f if line.startswith("Epoch:")]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert (res / "Fold-1 saved_model.pt" / "best.pt").is_file()
    monkeypatch.chdir(tmp_path)  # eval writes into the working directory
    assert main(["eval", *flags]) == 0
    assert os.path.isfile("Fold-1 test_acc_imgwise.csv")
    preds = tmp_path / "preds"
    assert main(["predict", *flags, "--out_dir", str(preds),
                 "--max_pages", "2"]) == 0
    assert sorted(os.listdir(preds))[-1] == "retrieval.csv"
    assert len(os.listdir(preds)) == 3
