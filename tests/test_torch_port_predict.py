"""``predict`` end to end through both CLIs, and the port's hygiene: it
imports no JAX and nothing of ``cova_tpu``, and it never drops to the CPU
unless asked to."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cova_tpu.cli import main as jax_main
from cova_tpu_torch.cli import main as port_main
from cova_tpu_torch.config import Config
from cova_tpu_torch.models.cova import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "12", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference-format state_dict with random weights and random BN
    statistics, saved as a .pth."""
    torch.manual_seed(0)
    cfg = Config(img_height=64, context_size=3, hidden_dim=32,
                 bbox_hidden_dim=8, compute_dtype="float32")
    sd = build_model(cfg, device="cpu").state_dict()
    rng = np.random.default_rng(0)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape)).float()
        elif k.endswith("running_mean") or k.endswith("bias"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.2, v.shape)).float()
    path = str(tmp_path_factory.mktemp("w") / "saved_model.pth")
    torch.save(sd, path)
    return path


def _read(path):
    with open(path) as f:
        return [line.rstrip("\n").split(",") for line in f]


def test_predict_matches_jax_cli(weights, tmp_path):
    """Same pages, same weights: the same retrieval picks and per-box
    predictions. Scores and probabilities are written with 4 decimals, so
    they are compared to within one unit of the last digit (1e-4, plus
    float slack) rather than byte for byte."""
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        rc = main(["predict", *SMALL, *extra,
                   "--output_dir", str(tmp_path / f"results_{name}"),
                   "--torch_model", weights, "--out_dir", out,
                   "--max_pages", "3"])
        assert rc == 0
        outs[name] = out
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["port"]))
    assert "retrieval.csv" in files and len(files) == 4
    tol = dict(rtol=0, atol=1.01e-4)
    for name in files:
        want = _read(os.path.join(outs["jax"], name))
        got = _read(os.path.join(outs["port"], name))
        assert got[0] == want[0] and len(got) == len(want) > 1  # header
        g, w = np.array(got[1:]), np.array(want[1:])
        if name == "retrieval.csv":
            # page_id, class, box_index, x, y, w, h, score
            np.testing.assert_array_equal(g[:, :7], w[:, :7])
            np.testing.assert_allclose(g[:, 7].astype(float),
                                       w[:, 7].astype(float), **tol)
        else:
            # x, y, w, h, pred, p_<class>...
            np.testing.assert_array_equal(g[:, :5], w[:, :5])
            np.testing.assert_allclose(g[:, 5:].astype(float),
                                       w[:, 5:].astype(float), **tol)


def test_port_imports_no_jax_and_nothing_of_cova_tpu():
    """Every module of the port, and the port's corpus clone generator,
    import without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import cova_tpu_torch\n"
        "for m in pkgutil.walk_packages(cova_tpu_torch.__path__,"
        " 'cova_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('scripts/make_corpus_clone_torch.py')\n"
        "assert 'cova_tpu_torch.utils.rss' in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cova_tpu')]\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('cova_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 35, r.stdout  # every module was imported


def test_port_sources_name_no_jax_import():
    """No file of the port, and not ``chip_smoke.py``, holds an import of
    ``jax`` or of the JAX package (docstrings may name them)."""
    import re

    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|cova_tpu)\b",
        re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "cova_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    for mod in ("ops/conv3x3.py", "utils/pretrained.py",
                "data/decode_cache.py", "data/device_prefetch.py"):
        assert os.path.join(REPO, "cova_tpu_torch", mod) in files
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_port_corpus_scripts_drive_only_the_port():
    """The port's corpus scripts (``scripts/*_torch.*``) import nothing of
    JAX or the JAX package and run only ``cova_tpu_torch`` and the
    package-free ``corpus_oracle_summary.py``."""
    import glob
    import re

    scripts = sorted(glob.glob(os.path.join(REPO, "scripts", "*_torch.*")))
    names = [os.path.basename(p) for p in scripts]
    for name in ("make_corpus_clone_torch.py", "corpus_fold_torch.sh",
                 "corpus_protocol_torch.sh"):
        assert name in names
    jax_use = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|cova_tpu)\b"
        r"|-m\s+cova_tpu\b(?!_torch)|\bcova_tpu\.(?!\w*_torch)\w", re.M)
    for path in scripts:
        with open(path) as f:
            text = f.read()
        code = "\n".join(line for line in text.splitlines()
                         if not line.lstrip().startswith("#"))
        if path.endswith(".py"):  # its docstring names the JAX script
            code = code.split('"""', 2)[-1]
        assert not jax_use.search(code), path
    with open(os.path.join(REPO, "scripts", "corpus_oracle_summary.py")) as f:
        imports = re.findall(r"^(?:import|from)\s+(\w+)", f.read(), re.M)
    assert set(imports) <= {"argparse", "csv", "numpy", "os", "sys"}


def test_default_device_refuses_to_run_without_cuda(weights, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works here")
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        port_main(["predict", *SMALL, "--torch_model", weights,
                   "--out_dir", str(out)])
    assert "CUDA is not available" in str(e.value.code)
    assert not out.exists()  # nothing ran on the CPU


@pytest.mark.parametrize("flags", [["--model_parallel", "2"],
                                   ["--num_devices", "2"]])
def test_unported_options_are_refused(weights, tmp_path, flags,
                                      monkeypatch):
    """Multi-device is ported for train, eval and sweep; ``predict`` runs
    on one device whatever ``--num_devices`` and ``--model_parallel`` say,
    as the JAX package's does, so these options are no longer refused:
    no rank is started and the pages are predicted here."""
    from cova_tpu_torch.parallel import launch

    monkeypatch.setattr(launch, "spawn",
                        lambda *a, **k: pytest.fail("predict started ranks"))
    out = tmp_path / "o"
    assert port_main(["predict", *SMALL, "--device", "cpu", *flags,
                      "--torch_model", weights, "--out_dir", str(out)]) == 0
    assert (out / "retrieval.csv").is_file()


def test_missing_weights_are_refused(tmp_path):
    with pytest.raises(SystemExit) as e:
        port_main(["predict", *SMALL, "--device", "cpu",
                   "--output_dir", str(tmp_path)])
    assert "no weights" in str(e.value.code)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where CUDA is
    missing, and likewise when it is copied away from the repo."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run")
    src = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(src).read())
    for script, cwd in ((src, REPO), (str(alone), str(tmp_path))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
