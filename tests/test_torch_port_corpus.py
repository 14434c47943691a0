"""The port's corpus-scale tooling against the JAX package's, on the CPU at a
tiny size: ``scripts/make_corpus_clone_torch.py`` writes the files of
``scripts/make_corpus_clone.py`` byte for byte, ``corpus_oracle_summary.py``
reads its clone, and ``cova_tpu_torch.cli train`` on a clone with a valid
splits tree (prefixes of the real ``splits/Fold-1`` lists) writes the
artifacts of ``cova_tpu.cli train`` (``test_torch_port_cli_train.py``'s
rules)."""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from cova_tpu.cli import main as jax_main
from cova_tpu_torch.cli import main as port_main
from cova_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPT = "make_corpus_clone_torch.py"
SMALL = ["--img_height", "64", "-cs", "3", "-hd", "32", "-bbhd", "8",
         "--compute_dtype", "float32", "-nw", "2", "-e", "2"]
KEY = Config(context_size=3, hidden_dim=32, bbox_hidden_dim=8).params_key


def _run(script, argv):
    old = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(os.path.join(REPO, "scripts", script),
                       run_name="__main__")
    except SystemExit as e:  # the scripts sys.exit(main())
        assert (e.code or 0) == 0, f"{script} exited {e.code}"
    finally:
        sys.argv = old


def _clone(out, img_height, splits, *extra):
    """The port's clone generator as a command (it forks one process a
    core, which a test process holding JAX's threads should not do)."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", PORT_SCRIPT),
         "--out", out, "--img_height", str(img_height), "--splits", splits,
         *extra], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_clone(a, b):
    """The same file names; PNGs with the same pixels, every other file
    the same bytes."""
    assert _files(a) == _files(b)
    for name in _files(a):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)),
                                          np.asarray(Image.open(pb)))
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def tiny_splits(tmp_path_factory):
    """The splits tree of tests/test_corpus_clone.py: 8 ids, 3 of them
    Fold-1's test list."""
    splits = tmp_path_factory.mktemp("splits")
    (splits / "Fold-1").mkdir()
    ids = [str(i) for i in range(1, 9)]
    (splits / "all_imgs.txt").write_text("\n".join(ids) + "\n")
    (splits / "Fold-1" / "test_imgs.txt").write_text(
        "\n".join(ids[5:]) + "\n")
    return str(splits), ids


@pytest.fixture(scope="module")
def clones(tiny_splits, tmp_path_factory):
    """One clone from each package's generator, 128 px, seed 123."""
    splits, _ = tiny_splits
    root = tmp_path_factory.mktemp("clones")
    out = {k: str(root / k) for k in ("port", "jax")}
    _clone(out["port"], 128, splits)
    _run("make_corpus_clone.py", ["--out", out["jax"], "--img_height", "128",
                                  "--splits", splits])
    return out


def test_clone_equals_the_jax_scripts(clones, tiny_splits):
    """PNG pixels, bbox CSV text and ``corpus_oracle.csv``, byte for byte:
    the port's pages written by one process a core, the JAX script's by
    one process."""
    _, ids = tiny_splits
    _assert_same_clone(clones["port"], clones["jax"])
    assert len(_files(clones["port"])) == 2 * len(ids) + 1


def test_clone_keeps_the_jax_box_count_draw():
    """The clipped-normal box count (11 / 230 / 93 / 37.3), for other
    seeds than the fixture's."""
    port = runpy.run_path(os.path.join(REPO, "scripts", PORT_SCRIPT))
    ref = runpy.run_path(os.path.join(REPO, "scripts",
                                      "make_corpus_clone.py"))
    assert (port["BBOX_MIN"], port["BBOX_MAX"], port["BBOX_MEAN"],
            port["BBOX_STD"]) == (11, 230, 93.0, 37.3)
    for seed in (0, 7):
        counts = [port["n_boxes_for"](np.random.default_rng((seed, i)))
                  for i in range(200)]
        assert counts == [ref["n_boxes_for"](np.random.default_rng((seed, i)))
                          for i in range(200)]
        assert 11 <= min(counts) and max(counts) <= 230


def test_oracle_summary_reads_the_ports_clone(clones, tiny_splits, capsys):
    splits, _ = tiny_splits
    _run("corpus_oracle_summary.py",
         ["--clone", clones["port"], "--splits", splits, "--folds", "1"])
    got = capsys.readouterr().out
    assert "oracle latent" in got and "oracle visible" in got
    assert "   1       3  " in got  # Fold-1's row: its 3 test ids


def test_fold_subset_keeps_the_real_lists(tmp_path):
    """``fold_subset`` takes prefixes of the real Fold-1 lists, disjoint,
    with each id's domain from the fold's ``webpage_info.csv``."""
    sub = runpy.run_path(os.path.join(REPO, "scripts", PORT_SCRIPT))[
        "fold_subset"]
    ids = sub(os.path.join(REPO, "splits"), str(tmp_path), 1, 6, 3, 3)
    fold = tmp_path / "Fold-1"
    real = os.path.join(REPO, "splits", "Fold-1")
    for name, n in (("train", 6), ("val", 3), ("test", 3)):
        got = (fold / f"{name}_imgs.txt").read_text().split()
        want = open(os.path.join(real, f"{name}_imgs.txt")).read().split()
        assert got == want[:n]
    assert (tmp_path / "all_imgs.txt").read_text().split() == ids
    assert len(set(ids)) == 12
    with open(os.path.join(real, "webpage_info.csv")) as f:
        info = dict(line.split(",") for line in f.read().split()[1:])
    rows = (fold / "webpage_info.csv").read_text().split()
    assert rows[0] == "webpage_name,domain"
    assert [r.split(",") for r in rows[1:]] == [[i, info[i]] for i in ids]
    test = (fold / "test_imgs.txt").read_text().split()
    assert (fold / "test_domains.txt").read_text().split() == sorted(
        {info[i] for i in test})


@pytest.fixture(scope="module")
def trained_on_clone(tmp_path_factory):
    """Both CLIs train two epochs on one 64 px clone of 20 real Fold-1 ids
    (12 train, 4 val, 4 test)."""
    root = tmp_path_factory.mktemp("clone_train")
    splits, clone = str(root / "splits"), str(root / "clone")
    sub = runpy.run_path(os.path.join(REPO, "scripts", PORT_SCRIPT))[
        "fold_subset"]
    sub(os.path.join(REPO, "splits"), splits, 1, 12, 4, 4)
    _clone(clone, 64, splits, "--no-oracle")
    out = dict(clone=clone, splits=splits)
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out_dir = str(root / name)
        assert main(["train", "--data_dir", clone, "--split_dir", splits,
                     *SMALL, *extra, "--output_dir", out_dir]) == 0
        out[name] = os.path.join(out_dir, KEY)
    return out


def test_train_on_the_clone_writes_the_jax_artifacts(trained_on_clone):
    """The same files (the orbax directory becomes ``Fold-1
    saved_model.pt``), CSV headers, log and report formats; two finite
    epoch losses each; the test reports list the same pages and the same
    domains in the same order. The two CLIs initialise from different
    RNGs, so the numbers of these runs are not compared here: the losses
    are in ``test_torch_port_train.py``, and the numbers on this disk path
    in the eval test below, from one set of weights."""
    import re

    jax_dir, port_dir = trained_on_clone["jax"], trained_on_clone["port"]
    jax_files = [f for f in _files(jax_dir) if ".orbax" not in f]
    port_files = [f for f in _files(port_dir) if "saved_model.pt" not in f]
    assert port_files == jax_files

    def shape(line):
        return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line.rstrip("\n"))

    for name in jax_files:
        if name == "metrics.jsonl":
            continue
        want = open(os.path.join(jax_dir, name)).readlines()
        got = open(os.path.join(port_dir, name)).readlines()
        assert [shape(x) for x in got] == [shape(x) for x in want], name
        if name.endswith(".csv"):
            assert got[0] == want[0], name
        if name.startswith("Fold-1 test_acc_"):
            assert [x.split(",")[0] for x in got] == [
                x.split(",")[0] for x in want], name
    log = open(os.path.join(port_dir, "Fold-1 logs.txt")).read()
    losses = [float(x) for x in re.findall(r"Epoch:\s*\d+\s+Loss: ([\d.]+)",
                                           log)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    imgwise = open(os.path.join(port_dir, "Fold-1 test_acc_imgwise.csv"))
    assert len(imgwise.readlines()) == 1 + 4


def test_eval_on_the_clone_matches_the_jax_cli(trained_on_clone, tmp_path,
                                               monkeypatch):
    """One set of weights (the port's run, exported) evaluated by both
    CLIs on the clone's Fold-1 test pages, through the disk path: PNG
    decode, a decode cache, the real fold lists and domains. The three
    reports are the same text, accuracies included (the timing blanked);
    ``predict`` makes the same picks, with scores within one unit of their
    fourth decimal (``test_torch_port_export.py``'s rule)."""
    import re

    t = trained_on_clone
    data = ["--data_dir", t["clone"], "--split_dir", t["splits"], *SMALL]
    out_dir = os.path.dirname(t["port"])
    assert port_main(["export", *data, "--device", "cpu",
                      "--output_dir", out_dir]) == 0
    pth = os.path.join(t["port"], "Fold-1 saved_model.pth")
    reports = ("Fold-1 test_acc_classwise.txt", "Fold-1 test_acc_imgwise.csv",
               "Fold-1 test_acc_domainwise.csv")
    got = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        flags = [*data, *extra, "--torch_model", pth,
                 "--decode_cache", str(tmp_path / f"{name}_cache"),
                 "--output_dir", str(tmp_path / f"{name}_out")]
        assert main(["eval", *flags]) == 0
        assert main(["predict", *flags, "--out_dir", str(cwd / "preds")]) == 0
        got[name] = [re.sub(r" \(\d+\.\d+s\)", "", open(cwd / f).read())
                     for f in reports]
        assert os.listdir(tmp_path / f"{name}_cache")
    assert got["port"] == got["jax"]
    assert len(got["port"][1].splitlines()) == 1 + 4
    preds = {name: tmp_path / name / "preds" for name in got}
    files = sorted(os.listdir(preds["jax"]))
    assert files == sorted(os.listdir(preds["port"])) and len(files) == 5
    for name in files:
        want, have = (np.array([line.split(",") for line in
                                open(preds[k] / name).read().splitlines()])
                      for k in ("jax", "port"))
        assert have.shape == want.shape and have.shape[0] > 1
        n = 7 if name == "retrieval.csv" else 5  # picks / box and pred
        np.testing.assert_array_equal(have[:, :n], want[:, :n])
        np.testing.assert_allclose(have[1:, n:].astype(float),
                                   want[1:, n:].astype(float),
                                   rtol=0, atol=1.01e-4)


@pytest.mark.parametrize("n", [1, 3])
def test_fold_lists_of_any_length_load(tmp_path, n):
    """``load_fold_ids`` reads split lists of one id as lists (a prefix of
    one page per split is a valid fold), and longer ones as the JAX
    package's reader does."""
    from cova_tpu.data.dataset import load_fold_ids as jax_load
    from cova_tpu_torch.data.dataset import load_fold_ids

    sub = runpy.run_path(os.path.join(REPO, "scripts", PORT_SCRIPT))[
        "fold_subset"]
    ids = sub(os.path.join(REPO, "splits"), str(tmp_path), 1, n, n, n)
    got = load_fold_ids(str(tmp_path / "Fold-1"))
    assert [a.tolist() for a in got[:3]] == [ids[:n], ids[n:2 * n],
                                             ids[2 * n:]]
    assert got[4].ndim == 1 and len(got[3]) == 3 * n
    if n > 1:
        for a, b in zip(got, jax_load(str(tmp_path / "Fold-1"))):
            np.testing.assert_array_equal(a, b)


def test_protocol_for_other_folds_keeps_fold1_reports(tmp_path):
    """``scripts/corpus_protocol_torch.sh 2`` on the CPU (a 64 px clone of
    prefixes of the real Fold-2 lists, the README's TRAIN_ARGS) trains
    Fold-2 and adds its row to ``fold_wise_acc.csv``; Fold-1's eval and
    visualize reports of an earlier call, whose checkpoint a fresh checkout
    lacks, stay as they were, byte for byte."""
    splits, clone, out = (str(tmp_path / d)
                          for d in ("splits", "clone", "out"))
    sub = runpy.run_path(os.path.join(REPO, "scripts", PORT_SCRIPT))[
        "fold_subset"]
    sub(os.path.join(REPO, "splits"), splits, 2, 12, 4, 4)
    os.makedirs(out)
    planted = {}
    for name in ("eval_fold1_console.log", "visualize_console.log"):
        planted[name] = f"{name} of an earlier Fold-1 call\n".encode()
        with open(os.path.join(out, name), "wb") as f:
            f.write(planted[name])
    env = dict(os.environ, SPLITS=splits, CLONE=clone, OUT=out, IMGH="64",
               DEVICE="cpu", TMPDIR=str(tmp_path),
               TRAIN_ARGS="-e 2 -cs 3 -hd 32 -bbhd 8 --compute_dtype "
                          "float32 -nw 2")
    r = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "corpus_protocol_torch.sh"),
         "2"], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert "rc=0 done fold2" in r.stdout
    assert "Fold-1 eval" not in r.stdout
    for name, data in planted.items():
        with open(os.path.join(out, name), "rb") as f:
            assert f.read() == data, name
    assert not os.path.exists(os.path.join(out, "eval_fold1"))
    with open(os.path.join(out, KEY, "fold_wise_acc.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("Fold,val_avg,")
    assert [r.split(",")[0] for r in rows[1:]] == ["2"]
    with open(os.path.join(out, KEY, "sweep_summary.txt")) as f:
        assert f.readline().strip() == "folds: [2]"
