"""The port's training path against the JAX package's, on the CPU.

The same initial weights (a JAX init carried across by
``state_dict_from_jax``) and the same batches (the JAX pipeline's, which
the port's pipeline reproduces byte for byte) go through three train steps
of ``cova_tpu.train.steps.train_step`` and of the port's ``train_step``;
losses, metrics, parameters and BN statistics are compared, then
``eval_step``. Also: the port's initialisation, dropout's generator, and
exact resume.
"""

import jax
import numpy as np
import pytest
import torch

from cova_tpu.config import Config as JaxConfig
from cova_tpu.data.pipeline import DataPipeline as JaxPipeline
from cova_tpu.data.synthetic import InMemoryWebDataset as JaxDataset
from cova_tpu.models.cova import build_model as jax_build_model
from cova_tpu.train import steps as jax_steps
from cova_tpu.utils.params import count_parameters as jax_count
from cova_tpu_torch.config import Config
from cova_tpu_torch.data.batching import Batch, bucket_batch, pad_batch
from cova_tpu_torch.models.cova import build_model
from cova_tpu_torch.models.layers import MaskedBatchNorm
from cova_tpu_torch.train.steps import (
    batch_to_device,
    create_train_state,
    eval_step,
    masked_ce_sum,
    train_step,
)
from cova_tpu_torch.train.trainer import dropout_generator
from cova_tpu_torch.utils.params import count_parameters
from cova_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(img_height=64, max_boxes=24, context_size=3, hidden_dim=32,
             bbox_hidden_dim=8, batch_size=3, eval_batch_size=3,
             compute_dtype="float32")


def _batches(n_steps, cfg_kw=SMALL):
    """n_steps padded, bucketed train batches of the JAX pipeline, as
    numpy (BG subsampling on, so the box count varies)."""
    jcfg = JaxConfig(**cfg_kw)
    ds = JaxDataset(3 * n_steps, 64, seed=0, min_boxes=4, max_boxes=24)
    pipe = JaxPipeline(ds, batch_size=3, pad_boxes=jcfg.pad_boxes,
                       context_size=jcfg.context_size, shuffle=True,
                       sampling_fraction=0.9, seed=jcfg.seed, num_threads=1)
    out = []
    for _, b in pipe.epoch(1):
        b = Batch(*b)
        out.append(bucket_batch(pad_batch(b, 3)[0], jcfg.box_buckets))
    return jcfg, out


@pytest.fixture(scope="module")
def three_steps():
    """Three steps on both sides from the same weights, drop_prob 0."""
    jcfg, batches = _batches(3)
    jcfg = JaxConfig(**SMALL, drop_prob=0.0)
    model = jax_build_model(jcfg)
    jstate = jax_steps.create_train_state(
        model, jcfg, pad_batch(batches[0], 3)[0], jax.random.PRNGKey(0))
    cfg = Config(**SMALL, drop_prob=0.0)
    params0, stats0 = jax.device_get((jstate.params, jstate.batch_stats))
    sd0 = state_dict_from_jax(params0, stats0, cfg)

    # The first step's gradients, before any optimizer moves the weights.
    def jax_loss(params):
        out, _ = jax_steps._apply(jstate, params, batches[0], train=True,
                                  rng=jax.random.PRNGKey(0))
        return jax_steps.masked_ce_sum(out.logits, batches[0].labels,
                                       batches[0].box_mask)

    jgrads = jax.device_get(jax.grad(jax_loss)(jstate.params))
    probe = build_model(cfg, device="cpu").train()
    probe.load_state_dict(sd0)
    out = probe(**batch_to_device(batches[0], "cpu"))
    masked_ce_sum(out.logits, torch.from_numpy(batches[0].labels),
                  torch.from_numpy(batches[0].box_mask)).backward()

    port = build_model(cfg, device="cpu")
    port.load_state_dict(sd0)
    state = create_train_state(port, cfg)

    jax_m, port_m = [], []
    for i, b in enumerate(batches):
        jstate, m = jax_steps.train_step(jstate, b, jax.random.PRNGKey(i))
        jax_m.append({k: float(v) for k, v in m.items()})
        port_m.append({k: float(v) for k, v in train_step(state, b).items()})
    jparams, jstats = jax.device_get((jstate.params, jstate.batch_stats))
    return dict(cfg=cfg, batches=batches, jstate=jstate, state=state,
                jax_m=jax_m, port_m=port_m,
                jax_sd=state_dict_from_jax(jparams, jstats, cfg),
                jax_grads=state_dict_from_jax(jgrads, stats0, cfg),
                port_grads={k: p.grad for k, p in probe.named_parameters()})


def test_train_steps_match_jax_losses_and_counts(three_steps):
    """Per step: the summed CE loss to rtol 1e-5 (f32 forward; the
    frameworks sum convs and matmuls in other orders), the box count
    exactly, the argmax-correct count exactly."""
    for jm, pm in zip(three_steps["jax_m"], three_steps["port_m"]):
        assert pm["n_boxes"] == jm["n_boxes"] > 0
        assert pm["n_correct"] == jm["n_correct"]
        np.testing.assert_allclose(pm["loss_sum"], jm["loss_sum"],
                                   rtol=1e-5)
    losses = [m["loss_sum"] / m["n_boxes"] for m in three_steps["port_m"]]
    assert np.isfinite(losses).all()


def test_first_step_gradients_match_jax(three_steps):
    """Every parameter's gradient of the first step (the whole training
    forward and backward: RoIPool and the fused stem pool through their
    autograd functions, the BN gradient through the batch statistics)
    equals ``jax.grad`` of the JAX loss at the same weights, mapped through
    ``state_dict_from_jax``: rtol 1e-4 and atol 1e-5 times the tensor's
    largest gradient plus 1e-6 (f32; the frameworks sum in other orders;
    the gradient of a Linear bias before a BN is zero but for rounding
    noise of ~1e-9)."""
    want, got = three_steps["jax_grads"], three_steps["port_grads"]
    assert set(got) <= set(want) and len(got) > 20
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max())
                                   + 1e-6,
                                   err_msg=k)


def test_train_steps_match_jax_parameters_and_bn_stats(three_steps):
    """After three Adam steps, every parameter and BN running statistic,
    mapped back through ``state_dict_from_jax``. Adam moves a weight by
    about lr (5e-4) per step whatever its gradient's size, so where a
    gradient component nearly cancels (the Linear bias before a BN has a
    gradient that is zero but for rounding) the frameworks' f32 rounding
    decides its step: such elements, and the BN statistics downstream of
    them, may differ by up to 3 steps x 2 lr. Everything else agrees to
    rtol 1e-4 / atol 1e-5: at least 99.9% of the elements."""
    want = three_steps["jax_sd"]
    got = three_steps["state"].model.state_dict()
    assert set(want) == set(got)
    lr = three_steps["cfg"].learning_rate
    n_all = n_off = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 3  # the port counts its BN updates
            continue
        g, w = got[k].numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=3 * 2 * lr,
                                   err_msg=k)
        n_all += w.size
        n_off += int((np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)).sum())
    assert n_all > 10_000 and n_off <= n_all // 1000
    assert three_steps["state"].step == 3


def test_eval_step_matches_jax(three_steps):
    """``eval_step`` on the trained weights: the same retrieval hits and
    the same presence flags as the JAX ``eval_step``, page by page."""
    b = pad_batch(three_steps["batches"][0], 3)[0]
    want = jax_steps.eval_step(three_steps["jstate"], b, n_classes=4)
    got = eval_step(three_steps["state"].model, b, n_classes=4)
    np.testing.assert_array_equal(got["correct"].numpy(),
                                  np.asarray(want["correct"]))
    np.testing.assert_array_equal(got["present"].numpy(),
                                  np.asarray(want["present"]))


def test_masked_ce_sum_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 5)).astype(np.int32)
    mask = rng.random((2, 5)) < 0.7
    want = float(jax_steps.masked_ce_sum(logits, labels, mask))
    got = float(masked_ce_sum(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_parameter_count_matches_jax():
    """The flagship's 1,616,485 parameters, counted as the JAX package
    counts its params tree (and a small variant)."""
    for kw in ({}, dict(SMALL)):
        jcfg = JaxConfig(**kw)
        jmodel = jax_build_model(jcfg)
        _, batches = _batches(1) if kw else (None, None)
        if kw:
            b = batches[0]
        else:
            b = Batch(images=np.zeros((1, 320, 320, 48), np.uint8),
                      boxes=np.zeros((1, 8, 4), np.float32),
                      labels=np.zeros((1, 8), np.int32),
                      box_mask=np.ones((1, 8), bool),
                      context_indices=np.zeros((1, 8, 24), np.int32),
                      additional_feats=np.zeros((1, 8, 0), np.float32))
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0), b.images, b.boxes,
                                b.box_mask, b.context_indices, None,
                                train=False))
        n = count_parameters(build_model(Config(**kw), device="cpu"))
        assert n == jax_count(shapes["params"])
        if not kw:
            assert n == 1_616_485


def test_init_follows_the_jax_distributions():
    """Convs are ``he_normal`` (std sqrt(2 / fan_in), truncated at two of
    the pre-truncation std), Linears U(+-1/sqrt(fan_in)), as the JAX
    package initialises them; torch's default conv init (kaiming-uniform,
    a = sqrt(5), std sqrt(1 / (3 fan_in))) would fail the std check. The
    weights come from ``cfg.seed`` and leave torch's global RNG alone."""
    cfg = Config()
    torch.manual_seed(1)
    state = torch.get_rng_state()
    model = build_model(cfg, device="cpu")
    assert torch.equal(state, torch.get_rng_state())
    again = build_model(cfg, device="cpu").state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, again[k]), k
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 5
    for conv in convs:
        w = conv.weight.detach()
        std = (2.0 / w[0].numel()) ** 0.5
        assert abs(float(w.std()) / std - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978
    for lin in [m for m in model.modules() if isinstance(m, torch.nn.Linear)]:
        bound = 1.0 / lin.in_features ** 0.5
        for p in (lin.weight, lin.bias):
            assert p is None or float(p.detach().abs().max()) <= bound
        std = float(lin.weight.detach().std())
        assert abs(std / (bound / 3**0.5) - 1.0) < 0.2
    for bn in [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]:
        assert (bn.weight == 1).all() and (bn.bias == 0).all()


@pytest.fixture
def one_thread():
    """torch's multithreaded CPU kernels (conv backward) may sum in an
    order that changes from run to run; one thread makes a run exactly
    repeatable."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_losses(drop_prob, global_seed):
    cfg = Config(**SMALL, drop_prob=drop_prob)
    _, batches = _batches(2)
    state = create_train_state(build_model(cfg, device="cpu"), cfg)
    torch.manual_seed(global_seed)  # must not matter
    gen = dropout_generator(cfg.seed, 1, "cpu")
    return [float(train_step(state, b, gen)["loss_sum"]) for b in batches]


def test_dropout_draws_from_the_explicit_generator(one_thread):
    """drop_prob 0.2: two runs from one seed give identical losses, even
    when torch's global RNG is seeded differently in between (dropout
    does not draw from it), and dropout does change the losses."""
    a = _train_losses(0.2, global_seed=1)
    b = _train_losses(0.2, global_seed=2)
    assert a == b
    assert a != _train_losses(0.0, global_seed=1)
    with pytest.raises(ValueError):
        cfg = Config(**SMALL, drop_prob=0.2)
        state = create_train_state(build_model(cfg, device="cpu"), cfg)
        train_step(state, _batches(1)[1][0])  # no generator


def test_dropout_generators_are_keyed_by_seed_and_epoch():
    draw = [torch.rand(4, generator=dropout_generator(s, e, "cpu"))
            for s, e in ((123, 1), (123, 1), (123, 2), (7, 1))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])
