"""``export`` through the port on the CPU: the written ``.pth`` equals the
JAX package's ``export_cova_state_dict`` of the same weights, and a model
trained by the port, exported, is served by the JAX CLI with the port's
own picks."""

import os

import numpy as np
import pytest
import torch

from cova_tpu.cli import main as jax_main
from cova_tpu.utils.torch_port import export_cova_state_dict
from cova_tpu_torch.cli import main as port_main
from cova_tpu_torch.config import Config
from cova_tpu_torch.models.cova import build_model
from cova_tpu_torch.train.steps import create_train_state
from cova_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from cova_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_model import _jax_case

SMALL = ["--synthetic", "12", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2"]
PORT = ["--device", "cpu"]


def _cfg(out_dir, n_add=0):
    return Config(output_dir=str(out_dir), img_height=64, context_size=3,
                  hidden_dim=32, bbox_hidden_dim=8, compute_dtype="float32",
                  use_additional_feat=n_add > 0, n_additional_feat=n_add)


def _save_best(cfg, sd):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    CheckpointManager(cfg.ckpt_dir()).save(
        "best", create_train_state(model, cfg),
        {"epoch": 1, "best_eval_acc": 0.0, "patience": 0})


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("n_add", [0, 4])
def test_export_equals_export_cova_state_dict(tmp_path, n_add):
    """One set of Flax weights: carried across into a port checkpoint and
    exported by the port's CLI, it gives the JAX package's export bit for
    bit; ``num_batches_tracked`` keeps its key and int64 dtype."""
    _, params, stats, _, _ = _jax_case(n_add=n_add)
    cfg = _cfg(tmp_path, n_add)
    _save_best(cfg, state_dict_from_jax(params, stats, cfg))
    af = ["--use_additional_feat"] if n_add else []
    assert port_main(["export", *SMALL, *PORT, *af,
                      "--output_dir", str(tmp_path)]) == 0
    got = _load(cfg.torch_model_path())
    want = export_cova_state_dict(
        params, stats, use_context=True, bbox_hidden_dim=8,
        n_additional_feat=n_add, roi=3)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        if want[k].is_floating_point():
            assert torch.equal(got[k], want[k]), k
    assert sum("num_batches_tracked" in k for k in got) == (
        7 + (n_add > 0))  # 5 backbone BNs, bbox, decoder (+ features)


def test_export_writes_f32_from_a_bf16_checkpoint(tmp_path):
    cfg = _cfg(tmp_path)
    sd = build_model(cfg, device="cpu").state_dict()
    low = {k: (v.bfloat16() if v.is_floating_point() else v)
           for k, v in sd.items()}
    os.makedirs(cfg.ckpt_dir(), exist_ok=True)
    torch.save({"model": low}, CheckpointManager(cfg.ckpt_dir()).path("best"))
    out = str(tmp_path / "sub" / "model.pth")
    assert port_main(["export", *SMALL, *PORT, "--output_dir",
                      str(tmp_path), "--out", out]) == 0
    got = _load(out)
    assert set(got) == set(sd)
    for k, v in got.items():
        assert v.dtype == sd[k].dtype, k  # f32 floats, int64 counts
        assert torch.equal(v, low[k].to(v.dtype)), k


def test_export_refuses_other_backbones_and_untrained_folds(tmp_path):
    with pytest.raises(SystemExit) as e:
        port_main(["export", *SMALL, *PORT, "--backbone", "resnet18",
                   "--output_dir", str(tmp_path)])
    assert "truncated resnet18 stem" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        port_main(["export", *SMALL, *PORT, "--output_dir", str(tmp_path)])
    assert "trained" in str(e.value.code)


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split(",") for line in f]


def test_port_train_export_serves_the_port_picks_in_the_jax_cli(tmp_path):
    """port train -> port export -> JAX ``predict --torch_model``: the JAX
    CLI picks the boxes the port's ``predict`` picks from its checkpoint
    (scores are written with 4 decimals: within one unit of the last)."""
    flags = [*SMALL, "--output_dir", str(tmp_path / "res")]
    assert port_main(["train", *flags, *PORT, "-e", "1"]) == 0
    assert port_main(["export", *flags, *PORT]) == 0
    cfg = _cfg(tmp_path / "res")
    pth = cfg.torch_model_path()
    sd, best = _load(pth), load_checkpoint(
        CheckpointManager(cfg.ckpt_dir()).path("best"))["model"]
    assert set(sd) == set(best)
    for k in sd:
        assert torch.equal(sd[k], best[k]), k
    assert int(sd["convnet.1.num_batches_tracked"]) > 0  # the steps counted
    outs = {}
    for name, main, extra in (("jax", jax_main, ["--torch_model", pth]),
                              ("port", port_main, PORT)):
        outs[name] = str(tmp_path / name)
        assert main(["predict", *flags, *extra, "--out_dir", outs[name],
                     "--max_pages", "3"]) == 0
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["port"])) and len(files) == 4
    for name in files:
        want = np.array(_rows(os.path.join(outs["jax"], name)))
        got = np.array(_rows(os.path.join(outs["port"], name)))
        assert got.shape == want.shape and got.shape[0] > 1
        n = 7 if name == "retrieval.csv" else 5  # picks / box and pred
        np.testing.assert_array_equal(got[:, :n], want[:, :n])
        np.testing.assert_allclose(got[1:, n:].astype(float),
                                   want[1:, n:].astype(float),
                                   rtol=0, atol=1.01e-4)
