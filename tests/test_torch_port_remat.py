"""``COVA_REMAT=1`` in the port is a pure memory-for-work trade, as in the
JAX package (``tests/test_remat.py``): the same state_dict keys, the same
loss and gradients, and the same BatchNorm running statistics after one
step. ``torch.utils.checkpoint`` runs each block's forward a second time
in the backward; that second run must not update the running statistics
again.
"""

import numpy as np
import pytest
import torch

from cova_tpu_torch.config import Config
from cova_tpu_torch.data.pipeline import make_pipelines
from cova_tpu_torch.data.synthetic import InMemoryWebDataset
from cova_tpu_torch.models import resnet
from cova_tpu_torch.models.cova import build_model
from cova_tpu_torch.models.layers import MaskedBatchNorm, frozen_running_stats
from cova_tpu_torch.train.steps import create_train_state, train_step

SMALL = dict(img_height=64, max_boxes=24, context_size=3, hidden_dim=32,
             bbox_hidden_dim=8, batch_size=2, eval_batch_size=2,
             compute_dtype="float32", drop_prob=0.0)


def _one_step(name, remat, monkeypatch):
    monkeypatch.setenv("COVA_REMAT", "1" if remat else "0")
    assert resnet.use_remat() == remat
    # One RoI bin for resnet50: 2048 channels x 9 bins would make the
    # decoder an 18k x 18k matrix.
    cfg = Config(**SMALL, backbone=name, roi=1 if name == "resnet50" else 3)
    ds = InMemoryWebDataset(2, 64, seed=1, min_boxes=4, max_boxes=24)
    _, batch = next(iter(make_pipelines(cfg, ds, ds, ds)[0].epoch(1)))
    calls = []
    real = resnet.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(resnet, "checkpoint", counted)
    state = create_train_state(build_model(cfg, device="cpu"), cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    model = state.model
    # The gradients, as the step computes them (the optimizer frees none).
    m = train_step(state, batch)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return dict(loss=float(m["loss_sum"]), grads=grads, before=before,
                after=model.state_dict(), n_checkpoints=len(calls))


@pytest.mark.parametrize("name", ["resnet18_stem", "resnet18", "resnet50"])
def test_remat_is_a_pure_memory_trade(name, monkeypatch):
    off = _one_step(name, False, monkeypatch)
    on = _one_step(name, True, monkeypatch)
    n_blocks = {"resnet18_stem": 2, "resnet18": 8, "resnet50": 16}[name]
    assert off["n_checkpoints"] == 0 and on["n_checkpoints"] == n_blocks
    # Same keys and the same seeded init: checkpoints interchange.
    assert list(off["before"]) == list(on["before"])
    for k in off["before"]:
        assert torch.equal(off["before"][k], on["before"][k]), k
    assert on["loss"] == off["loss"]
    for k, g in off["grads"].items():
        # The recomputed forward repeats the first; the backward then adds
        # each weight's gradient in another order (f32).
        np.testing.assert_allclose(
            on["grads"][k].numpy(), g.numpy(), rtol=1e-4,
            atol=1e-5 * float(g.abs().max()) + 1e-6, err_msg=k)
    n_stats = 0
    for k, v in off["after"].items():
        if "running_" in k or k.endswith("num_batches_tracked"):
            assert torch.equal(on["after"][k], v), k  # forward only: exact
        else:  # one Adam step moves a weight by at most about lr
            assert (on["after"][k] - v).abs().max() <= 2 * 5e-4, k
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k  # one update, not one per forward run
            n_stats += 1
        if k.endswith("running_mean") and k.startswith("convnet.4"):
            assert not torch.equal(v, off["before"][k]), k  # it did update
    assert n_stats > 4


def test_remat_is_off_without_grad(monkeypatch):
    """Inference takes no checkpoint, whatever the flag."""
    monkeypatch.setenv("COVA_REMAT", "1")
    called = []
    monkeypatch.setattr(resnet, "checkpoint",
                        lambda *a, **kw: called.append(1))
    bb = resnet.make_backbone("resnet18_stem").eval()
    with torch.no_grad():
        out = bb(torch.zeros(1, 16, 16, 48))
    assert tuple(out.shape) == (1, 16, 16, 64) and not called


def test_frozen_running_stats_keeps_batch_statistics():
    """Inside ``frozen_running_stats`` a training-mode BN normalizes with
    the batch statistics, exactly as outside, and leaves the running ones."""
    bn = MaskedBatchNorm(4).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        1.0, 2.0, (3, 5, 4)).astype(np.float32))
    with frozen_running_stats():
        y_frozen = bn(x)
    assert int(bn.num_batches_tracked) == 0
    assert torch.equal(bn.running_mean, torch.zeros(4))
    y = bn(x)
    assert int(bn.num_batches_tracked) == 1
    assert torch.equal(y, y_frozen)
    assert not torch.equal(bn.running_mean, torch.zeros(4))
