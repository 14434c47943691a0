"""``visualize`` (attention extraction and its overlays) through both CLIs on
the CPU at a small size, from the same weights."""

import os

import numpy as np
import pytest
import torch

from cova_tpu.cli import main as jax_main
from cova_tpu.train.extract import _context_coords as jax_context_coords
from cova_tpu_torch.cli import main as port_main
from cova_tpu_torch.config import Config
from cova_tpu_torch.models.cova import build_model
from cova_tpu_torch.train.extract import _context_coords

SMALL = ["--synthetic", "12", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2"]
N_CTX = 6  # 2K context slots at -cs 3
DIR = "Fold-1 attention visualization"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference-format state_dict with random weights and random BN
    statistics, saved as a .pth."""
    torch.manual_seed(0)
    cfg = Config(img_height=64, context_size=3, hidden_dim=32,
                 bbox_hidden_dim=8, compute_dtype="float32")
    sd = build_model(cfg, device="cpu").state_dict()
    rng = np.random.default_rng(1)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape)).float()
        elif k.endswith("running_mean") or k.endswith("bias"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.2, v.shape)).float()
    path = str(tmp_path_factory.mktemp("w") / "saved_model.pth")
    torch.save(sd, path)
    return path


def _visualize(tmp_path, weights, extra):
    """Both CLIs' output dirs: name -> path."""
    outs = {}
    for name, main, dev in (("jax", jax_main, []),
                            ("port", port_main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(["visualize", *SMALL, *dev, *extra, "--torch_model",
                     weights, "--output_dir", str(out)]) == 0
        key = Config(context_size=3, hidden_dim=32,
                     bbox_hidden_dim=8).params_key
        outs[name] = os.path.join(out, key, DIR)
    return outs


def _csv(path):
    with open(path) as f:
        return np.array([line.rstrip("\n").split(",") for line in f])


def test_attention_csvs_match_the_jax_cli(tmp_path, weights):
    """One CSV per test page, non-BG rows only: coordinates, labels and
    context coordinates byte for byte, attention within one unit of the
    written %.3f."""
    outs = _visualize(tmp_path, weights, ["--no_render"])
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["port"]))
    assert len(files) == 3 and all(f.endswith(".csv") for f in files)
    for name in files:
        want = _csv(os.path.join(outs["jax"], name))
        got = _csv(os.path.join(outs["port"], name))
        assert got.shape == want.shape == (3, 5 + 5 * N_CTX), name
        np.testing.assert_array_equal(got[:, :-N_CTX], want[:, :-N_CTX])
        np.testing.assert_allclose(got[:, -N_CTX:].astype(float),
                                   want[:, -N_CTX:].astype(float),
                                   rtol=0, atol=1.01e-3)
        attn = got[:, -N_CTX:].astype(float)
        assert np.all(attn >= 0) and np.all(attn.sum(1) <= 1.0 + 3e-3)


def test_visualize_renders_one_png_per_target_under_the_jax_names(
        tmp_path, weights):
    outs = _visualize(tmp_path, weights, ["--max_pages", "2"])
    files = {n: sorted(os.listdir(d)) for n, d in outs.items()}
    assert files["port"] == files["jax"]
    csvs = [f for f in files["port"] if f.endswith(".csv")]
    pngs = [f for f in files["port"] if f.endswith(".png")]
    assert len(csvs) == 2
    want = sorted(
        f"{c[:-4]}_attn_{('BG', 'Price', 'Title', 'Image')[int(float(r))]}"
        ".png"
        for c in csvs
        for r in _csv(os.path.join(outs["port"], c))[:, 4])
    assert pngs == want and len(pngs) == 6
    for p in pngs:
        assert os.path.getsize(os.path.join(outs["port"], p)) > 0


def test_visualize_needs_context(tmp_path, weights):
    with pytest.raises(SystemExit) as e:
        port_main(["visualize", *SMALL, "--device", "cpu", "-cs", "0",
                   "--no_render", "--torch_model", weights,
                   "--output_dir", str(tmp_path)])
    assert "CONTEXT_SIZE > 0" in str(e.value.code)


def test_context_coords_match_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 60, (9, 4)).astype(np.float32)
    ctx = rng.integers(-1, 9, (9, 6)).astype(np.int32)
    got = _context_coords(boxes, ctx)
    want = jax_context_coords(boxes, ctx)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.all(got.reshape(9, 6, 4)[ctx == -1] == 0)
