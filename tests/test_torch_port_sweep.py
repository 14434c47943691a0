"""The hard-synthetic oracle, ``train --synthetic_hard`` and ``sweep``
through the port on the CPU, against the JAX package's."""

import os

import numpy as np
import pytest

from cova_tpu.cli import main as jax_main
from cova_tpu.cli import sweep_summary as jax_sweep_summary
from cova_tpu.data import synthetic as jax_synth
from cova_tpu_torch.cli import main as port_main
from cova_tpu_torch.cli import sweep_summary
from cova_tpu_torch.config import Config
from cova_tpu_torch.data import synthetic

SMALL = ["--synthetic", "12", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2", "-bs", "4"]
KEY = Config(context_size=3, hidden_dim=32, bbox_hidden_dim=8,
             batch_size=4).params_key


@pytest.fixture(scope="module", params=[(96, 0), (128, 4)],
                ids=["img96", "img128-af4"])
def hard_pair(request):
    """The same hard-mode pages from both packages."""
    img, n_af = request.param
    kw = dict(seed=5, n_additional_feat=n_af, hard=True)
    return (synthetic.InMemoryWebDataset(10, img, **kw),
            jax_synth.InMemoryWebDataset(10, img, **kw))


def test_assigned_colors_equal_the_jax_ones(hard_pair):
    port, jax_ds = hard_pair
    assert len(port._colors) == len(jax_ds._colors) == 10
    for a, b in zip(port._colors, jax_ds._colors):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    sub = port.subset([3, 1])
    assert sub._colors[0] is port._colors[3]


@pytest.mark.parametrize("visible", [False, True])
def test_oracle_scores_equal_the_jax_ones(hard_pair, visible):
    port, jax_ds = hard_pair
    n_inf = 0
    for i in range(len(port.ids)):
        img, boxes = port._images[i], port.all_boxes[i]
        if visible:
            got_c = synthetic.colors_from_image(img, boxes)
            want_c = jax_synth.colors_from_image(img, boxes)
            assert got_c.tobytes() == want_c.tobytes()
            tol = 8
        else:
            got_c = want_c = port._colors[i]
            tol = 0
        got = synthetic.oracle_scores(boxes, got_c, port.img_h,
                                      port.all_additional[i], color_tol=tol)
        want = jax_synth.oracle_scores(boxes, want_c, jax_ds.img_h,
                                       jax_ds.all_additional[i],
                                       color_tol=tol)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        n_inf += int(np.isinf(got).sum())
    assert n_inf > 0  # out-of-prior boxes score -inf on both sides


@pytest.mark.parametrize("visible", [False, True])
def test_oracle_retrieval_correct_equals_the_jax_one(hard_pair, visible):
    port, jax_ds = hard_pair
    got = synthetic.oracle_retrieval_correct(port, visible=visible)
    want = jax_synth.oracle_retrieval_correct(jax_ds, visible=visible)
    assert got.dtype == want.dtype == bool and got.shape == (10, 3)
    np.testing.assert_array_equal(got, want)


def test_oracle_rejects_easy_mode():
    with pytest.raises(ValueError):
        synthetic.oracle_retrieval_correct(
            synthetic.InMemoryWebDataset(2, 64))


def _lines(path):
    with open(path) as f:
        return f.readlines()


def test_train_synthetic_hard_writes_the_jax_oracle_csv(tmp_path):
    """``train --synthetic_hard``: the port writes the JAX CLI's
    ``oracle_acc.csv`` byte for byte, and the same ORACLE log lines."""
    res = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(["train", *SMALL, *extra, "-e", "1", "--synthetic_hard",
                     "-cvf", "2", "--output_dir", str(out)]) == 0
        res[name] = os.path.join(out, KEY)
    want = _lines(os.path.join(res["jax"], "oracle_acc.csv"))
    assert _lines(os.path.join(res["port"], "oracle_acc.csv")) == want
    assert len(want) == 2 and want[1].startswith("2,")
    logs = {n: [x for x in _lines(os.path.join(r, "Fold-2 logs.txt"))
                if x.startswith("[ORACLE")] for n, r in res.items()}
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 2


FOLD_WISE = (
    "Fold,val_avg,price_acc,price_macro_acc,title_acc,"
    "title_macro_acc,image_acc,image_macro_acc\n"
    "1,90,10,11,12,13,14,15\n"
    "2,90,20,21.5,22,23,24,25\n"
    "1,90,30,31,32,33.25,34,35\n"  # a re-run of fold 1: this row wins
    "3,80,40,41,42,43,44,45\n"
)
ORACLE = (
    "fold,price_latent,title_latent,image_latent,"
    "price_visible,title_visible,image_visible\n"
    "1,100.00,95.50,99.00,90.00,80.00,50.00\n"
    "2,98.00,97.00,96.00,88.00,77.00,66.00\n"
)


@pytest.mark.parametrize("oracle", [False, True])
@pytest.mark.parametrize("folds", [[1, 2], [1, 3], [2, 3, 1], [3], [4]])
def test_sweep_summary_text_equals_the_jax_one(tmp_path, folds, oracle):
    path = str(tmp_path / "fold_wise_acc.csv")
    with open(path, "w") as f:
        f.write(FOLD_WISE)
    if oracle:
        with open(tmp_path / "oracle_acc.csv", "w") as f:
            f.write(ORACLE)
    got = sweep_summary(path, folds)
    assert got == jax_sweep_summary(path, folds)
    assert (got is None) == (folds == [4])
    if got is not None and oracle and folds != [3]:
        assert "oracle latent:" in got and "oracle visible:" in got


def test_cli_sweep_writes_the_summary(tmp_path):
    """``sweep --folds 1 2 --synthetic_hard``: both folds train in this
    process, and ``sweep_summary.txt`` aggregates their rows and the
    oracle band."""
    out = str(tmp_path / "res")
    assert port_main(["sweep", *SMALL, "--device", "cpu", "-e", "1",
                      "--synthetic_hard", "--output_dir", out,
                      "--folds", "1", "2"]) == 0
    rd = os.path.join(out, KEY)
    rows = np.loadtxt(os.path.join(rd, "fold_wise_acc.csv"), delimiter=",",
                      skiprows=1, ndmin=2)
    assert sorted(rows[:, 0].astype(int).tolist()) == [1, 2]
    orows = np.loadtxt(os.path.join(rd, "oracle_acc.csv"), delimiter=",",
                       skiprows=1, ndmin=2)
    assert orows[:, 0].astype(int).tolist() == [1, 2]
    with open(os.path.join(rd, "sweep_summary.txt")) as f:
        text = f.read()
    assert text == sweep_summary(os.path.join(rd, "fold_wise_acc.csv"),
                                 [1, 2])
    assert text.startswith("folds: [1, 2]\n")
    for label in ("classwise:", "macro:", "oracle latent:",
                  "oracle visible:"):
        assert label in text
