"""``train`` and ``eval`` through both CLIs, the test reports, and exact
resume, on the CPU at a small size."""

import json
import os
import re

import numpy as np
import pytest
import torch

from cova_tpu.cli import main as jax_main
from cova_tpu.train import reporting as jax_reporting
from cova_tpu_torch.cli import main as port_main
from cova_tpu_torch.config import Config
from cova_tpu_torch.train import reporting as port_reporting
from cova_tpu_torch.utils.checkpoint import load_checkpoint

SMALL = ["--synthetic", "12", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2"]
PORT = ["--device", "cpu"]
KEY = Config(context_size=3, hidden_dim=32, bbox_hidden_dim=8).params_key


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _shape(line):
    """A log line with its numbers blanked: the format, not the values."""
    return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line.rstrip("\n"))


def _lines(path):
    with open(path) as f:
        return f.readlines()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One fold trained for two epochs by each CLI."""
    root = tmp_path_factory.mktemp("train")
    out = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, PORT)):
        out_dir = str(root / name)
        assert main(["train", *SMALL, *extra, "-e", "2",
                     "--output_dir", out_dir]) == 0
        out[name] = os.path.join(out_dir, KEY)
    return out


def test_train_writes_the_jax_artifacts(trained):
    """The same artifact files (the orbax checkpoint directory becomes
    ``Fold-1 saved_model.pt`` with ``best.pt`` and ``last.pt``), the same
    CSV headers, the same log and metrics formats."""
    jax_files = [f for f in _files(trained["jax"]) if ".orbax" not in f]
    port_files = _files(trained["port"])
    ckpt = [f for f in port_files if "saved_model.pt" in f]
    assert sorted(ckpt) == ["Fold-1 saved_model.pt/best.pt",
                            "Fold-1 saved_model.pt/last.pt"]
    assert os.path.isdir(os.path.join(trained["jax"],
                                      "Fold-1 saved_model.orbax"))
    assert [f for f in port_files if f not in ckpt] == jax_files
    for name in jax_files:
        want = _lines(os.path.join(trained["jax"], name))
        got = _lines(os.path.join(trained["port"], name))
        if name == "metrics.jsonl":
            w, g = [json.loads(x) for x in want], [json.loads(x) for x in got]
            assert [(r["event"], sorted(r)) for r in g] == [
                (r["event"], sorted(r)) for r in w]
            assert all(np.isfinite(r.get("loss", 0.0)) for r in g)
            continue
        assert len(got) == len(want), name
        if name.endswith(".csv"):
            assert got[0] == want[0], name  # the header, byte for byte
        assert [_shape(x) for x in got] == [_shape(x) for x in want], name


def test_checkpoints_hold_a_full_train_state(trained):
    ckpt = load_checkpoint(os.path.join(trained["port"],
                                        "Fold-1 saved_model.pt", "last.pt"))
    assert sorted(ckpt) == ["extra", "model", "optimizer", "step"]
    assert ckpt["extra"]["epoch"] == 2 and ckpt["step"] == 2 * 2
    assert set(ckpt["extra"]) == {"epoch", "best_eval_acc", "patience"}
    assert "convnet.0.weight" in ckpt["model"]  # the reference namespace
    assert len(ckpt["optimizer"]["state"]) == len(ckpt["optimizer"][
        "param_groups"][0]["params"])


def test_eval_and_predict_use_the_best_checkpoint(trained, tmp_path,
                                                  monkeypatch):
    """``eval`` writes the reference's reports into the working directory
    and ``predict`` its CSVs, both from the fold's best checkpoint when no
    ``--torch_model`` is given; eval's test accuracy equals the one train
    reported (same weights, same pages)."""
    out_dir = os.path.dirname(trained["port"])
    monkeypatch.chdir(tmp_path)
    assert port_main(["eval", *SMALL, *PORT, "--output_dir", out_dir]) == 0
    for f in ("Fold-1 test_acc_classwise.txt", "Fold-1 test_acc_imgwise.csv",
              "Fold-1 test_acc_domainwise.csv"):
        assert os.path.isfile(tmp_path / f), f
    assert _lines(tmp_path / "Fold-1 test_acc_imgwise.csv") == _lines(
        os.path.join(trained["port"], "Fold-1 test_acc_imgwise.csv"))
    preds = tmp_path / "preds"
    assert port_main(["predict", *SMALL, *PORT, "--output_dir", out_dir,
                      "--out_dir", str(preds), "--max_pages", "2"]) == 0
    assert sorted(os.listdir(preds))[-1] == "retrieval.csv"
    assert len(os.listdir(preds)) == 3


@pytest.mark.parametrize("flags", [["--model_parallel", "2"],
                                   ["--synthetic_hard", "--num_devices", "2"],
                                   ["--num_devices", "2"],
                                   ["--num_devices", "0"]])
def test_train_refuses_what_is_not_ported(tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        port_main(["train", *SMALL, *PORT, "-e", "1", *flags,
                   "--output_dir", str(tmp_path)])
    assert "not ported" in str(e.value.code) or "one device" in str(
        e.value.code)
    assert not os.listdir(tmp_path)


def test_resume_continues_exactly(tmp_path):
    """Two epochs straight equal one epoch, then ``--resume`` for a second:
    the same final weights, BN statistics and optimizer state, bit for bit
    (dropout on; one CPU thread, so every sum repeats exactly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
        args = ["train", *SMALL, *PORT, "-dp", "0.2"]
        assert port_main([*args, "-e", "2", "--output_dir", straight]) == 0
        assert port_main([*args, "-e", "1", "--output_dir", resumed]) == 0
        assert port_main([*args, "-e", "2", "--resume",
                          "--output_dir", resumed]) == 0
    finally:
        torch.set_num_threads(n)
    key = Config(context_size=3, hidden_dim=32, bbox_hidden_dim=8,
                 drop_prob=0.2).params_key
    last = [load_checkpoint(os.path.join(d, key, "Fold-1 saved_model.pt",
                                         "last.pt"))
            for d in (straight, resumed)]
    assert last[0]["step"] == last[1]["step"] == 4
    for k, v in last[0]["model"].items():
        assert torch.equal(v, last[1]["model"][k]), k
    for s0, s1 in zip(last[0]["optimizer"]["state"].values(),
                      last[1]["optimizer"]["state"].values()):
        assert all(torch.equal(s0[k], s1[k]) for k in s0)
    log = _lines(os.path.join(resumed, key, "Fold-1 logs.txt"))
    assert any(line.startswith("Resuming from epoch 2") for line in log)


def test_reports_are_byte_identical_to_jax(tmp_path, monkeypatch):
    """``evaluate`` and ``append_fold_row`` of both packages, for the same
    per-page hits, domains and accuracies, write the same bytes (the
    domain rows rounded to two decimals before the macro mean)."""
    rng = np.random.default_rng(0)
    ids = np.arange(20)
    img_acc = np.column_stack([ids, rng.integers(0, 2, (20, 3))]).astype(
        np.int32)
    class_acc = np.r_[0.0, img_acc[:, 1:].mean(0) * 100]
    webpage_info = np.stack([ids.astype(str), np.array(
        [f"d{i % 3}.com" for i in ids])], axis=1)
    test_domains = np.array(["d0.com", "d1.com", "d2.com"])
    for mod in (jax_reporting, port_reporting):
        monkeypatch.setattr(mod, "run_eval",
                            lambda *a, **k: (img_acc, class_acc))
    names = ("BG", "Price", "Title", "Image")
    macro = {}
    for tag, mod in (("jax", jax_reporting), ("port", port_reporting)):
        d = tmp_path / tag
        d.mkdir()
        _, macro[tag] = mod.evaluate(
            None, None, 4, names, str(d / "log.txt"), str(d / "img.csv"),
            webpage_info, test_domains, str(d / "dom.csv"))
        for fold in (1, 2):
            mod.append_fold_row(str(d / "folds.csv"), fold, 66.6667,
                                class_acc, macro[tag])
    np.testing.assert_array_equal(macro["port"], macro["jax"])
    for f in ("log.txt", "img.csv", "dom.csv", "folds.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f
