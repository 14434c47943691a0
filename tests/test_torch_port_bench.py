"""``bench`` through the port on the CPU at a small size: the benches' batch
is the JAX package's byte for byte, and each mode returns the JAX result's
keys and metric name and prints one JSON line."""

import json
import os

import numpy as np
import pytest
import torch

from cova_tpu import benchmarks as jax_bench
from cova_tpu.config import Config as JaxConfig
from cova_tpu.data.batching import bucket_batch as jax_bucket_batch
from cova_tpu.data.batching import collate as jax_collate
from cova_tpu.data.records import pad_page as jax_pad_page
from cova_tpu.data.synthetic import synth_image as jax_synth_image
from cova_tpu.data.synthetic import synth_record as jax_synth_record
from cova_tpu_torch import benchmarks
from cova_tpu_torch.cli import main as port_main

TINY = dict(batch_size=2, steps=2, img_height=64, compute_dtype="float32",
            windows=1, context_size=3)
CLI_TINY = ["--device", "cpu", "-bsb", "2", "--img_height", "64",
            "--compute_dtype", "float32", "--steps", "1"]


def _jax_bench_batch(batch_size, img_height, n_af, seed):
    """The batch as ``cova_tpu/benchmarks.py`` builds it."""
    cfg = JaxConfig(batch_size=batch_size, img_height=img_height,
                    use_additional_feat=n_af > 0, n_additional_feat=n_af)
    imgs, pages = [], []
    for i in range(batch_size):
        rng = np.random.default_rng((seed, i))
        rec = jax_synth_record(str(i), img_height, rng, min_boxes=60,
                               max_boxes=min(120, cfg.max_boxes),
                               n_additional_feat=n_af)
        imgs.append(jax_synth_image(rec, img_height, rng))
        pages.append(jax_pad_page(rec, cfg.pad_boxes, cfg.context_size,
                                  n_additional_feat=n_af))
    return jax_bucket_batch(jax_collate(imgs, pages), cfg.box_buckets)


@pytest.mark.parametrize("af", [False, True])
@pytest.mark.parametrize("seed", [benchmarks.TRAIN_SEED,
                                  benchmarks.INFER_SEED])
def test_bench_batch_is_the_jax_construction(seed, af):
    cfg = benchmarks.bench_config(3, 64, "float32", af)
    got = benchmarks.bench_batch(cfg, seed)
    want = _jax_bench_batch(3, 64, 4 if af else 0, seed)
    assert got.boxes.shape[1] == 128  # 60..120 boxes: the 128 bucket
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def test_first_boxes_is_a_valid_batch_at_each_bucket():
    """The e2e warm-up cuts a batch to each bucket's box dim: every context
    slot then points inside the cut (or is padding)."""
    cfg = benchmarks.bench_config(2, 64, "float32", False)
    batch = benchmarks.bench_batch(cfg, benchmarks.TRAIN_SEED)
    for t in (64, 128):
        cut = benchmarks._first_boxes(batch, t)
        assert all(a.shape[1] == t for a in cut[1:])
        assert cut.context_indices.max() < t
        assert cut.context_indices.dtype == batch.context_indices.dtype
        keep = batch.context_indices[:, :t] < t
        np.testing.assert_array_equal(cut.context_indices[keep],
                                      batch.context_indices[:, :t][keep])


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_bench_result_has_the_jax_keys(mode):
    fn = {"train": "run_train_bench", "infer": "run_infer_bench"}[mode]
    want = getattr(jax_bench, fn)(**TINY)
    got = getattr(benchmarks, fn)(**TINY, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["metric"] == want["metric"]
    assert got["unit"] == "pages/s" and got["value"] > 0
    assert got["step_ms"] > 0 and got["device"] == "cpu"
    # The torch-CPU anchor was measured at 1280^2: no ratio at 64^2.
    assert got["vs_baseline"] is None
    json.dumps(got)


def _short_compute(mp, module):
    """The e2e bench's train-bench reading cut to one step in one window:
    its keys, not its time, are under test here (the train bench has its
    own test)."""
    full = module.run_train_bench
    mp.setattr(module, "run_train_bench",
               lambda **kw: full(**kw, steps=1, windows=1))


@pytest.fixture(scope="module")
def jax_e2e_disk():
    with pytest.MonkeyPatch.context() as mp:
        _short_compute(mp, jax_bench)
        return jax_bench.run_e2e_bench(batch_size=2, n_pages=6, epochs=1,
                                       img_height=64,
                                       compute_dtype="float32",
                                       source="disk")


@pytest.mark.parametrize("source", ["disk", "mem"])
def test_e2e_bench_result_has_the_jax_keys(jax_e2e_disk, monkeypatch,
                                           source):
    _short_compute(monkeypatch, benchmarks)
    got = benchmarks.run_e2e_bench(batch_size=2, n_pages=6, epochs=1,
                                   img_height=64, compute_dtype="float32",
                                   source=source, device="cpu")
    assert sorted(got) == sorted(jax_e2e_disk)
    assert got["metric"] == jax_e2e_disk["metric"]
    assert got["source"] == source and got["value"] > 0
    assert got["compute_pages_per_sec"] > 0 and got["device"] == "cpu"
    json.dumps(got)


def test_vs_baseline_reads_the_torch_cpu_anchor():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "baseline_torch.json")) as f:
        base = json.load(f)
    assert benchmarks._vs_baseline(
        base["value"] * 3, "baseline_torch.json", base["geometry"]["img"]
    ) == pytest.approx(3)
    assert benchmarks._vs_baseline(1.0, "baseline_torch.json", 64) is None
    assert benchmarks._vs_baseline(1.0, "no_such_file.json", 1280) is None


@pytest.mark.parametrize("mode,extra", [
    ("train", []),
    ("infer", ["--use_additional_feat"]),
    ("e2e", ["--e2e_pages", "4", "--e2e_epochs", "1"]),
])
def test_cli_bench_prints_one_json_line(capsys, monkeypatch, mode, extra):
    if mode == "e2e":
        _short_compute(monkeypatch, benchmarks)
    assert port_main(["bench", "--mode", mode, *CLI_TINY, *extra]) == 0
    lines = [x for x in capsys.readouterr().out.splitlines() if x.strip()]
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == {
        "train": "train_webpages_per_sec_per_chip",
        "infer": "infer_webpages_per_sec_per_chip",
        "e2e": "e2e_train_webpages_per_sec",
    }[mode]
    assert r["batch_size"] == 2 and r["device"] == "cpu"
    if mode == "infer":
        assert r["use_additional_feat"] is True


@pytest.mark.parametrize("flags,want", [
    ([], 8),
    (["-bs", "3"], 3),
    (["-bs", "3", "-bsb", "2"], 2),
])
def test_cli_bench_batch_size_flags(monkeypatch, capsys, flags, want):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"metric": "infer_webpages_per_sec_per_chip"}

    monkeypatch.setattr(benchmarks, "run_infer_bench", fake)
    assert port_main(["bench", "--mode", "infer", "--device", "cpu",
                      "-cs", "5", *flags]) == 0
    assert seen["batch_size"] == want
    assert seen["context_size"] == 5 and seen["steps"] == 20
    assert seen["device"] == torch.device("cpu")
    assert json.loads(capsys.readouterr().out)["metric"].startswith("infer")


@pytest.mark.parametrize("command", ["bench", "export", "visualize",
                                     "sweep"])
def test_new_commands_refuse_to_run_without_cuda(tmp_path, command):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works here")
    with pytest.raises(SystemExit) as e:
        port_main([command, "--synthetic", "12", "--img_height", "64",
                   "--output_dir", str(tmp_path)])
    assert "CUDA is not available" in str(e.value.code)
    assert not any(tmp_path.iterdir())  # nothing ran on the CPU


@pytest.mark.parametrize("command", ["bench", "export", "visualize",
                                     "sweep"])
def test_new_commands_refuse_multi_gpu(tmp_path, command, monkeypatch):
    """Multi-device is ported for train, eval and sweep, so what is refused
    now is what the JAX package refuses: ``sweep --num_devices 2`` at the
    default ``-bs 5`` does not divide the global batch over the data axis,
    and the launching process says so before any rank starts; ``bench``,
    ``export`` and ``visualize`` run on one device whatever
    ``--num_devices`` says, as the JAX package's do (recorded here instead
    of run)."""
    from cova_tpu_torch import cli
    from cova_tpu_torch.parallel import launch

    started, here = [], []
    monkeypatch.setattr(launch, "spawn",
                        lambda argv, n: started.append((list(argv), n)) or 0)
    monkeypatch.setattr(cli, f"cmd_{command}",
                        lambda args: here.append(args.num_devices) or 0)
    argv = [command, "--device", "cpu", "--synthetic", "12",
            "--img_height", "64", "--num_devices", "2",
            "--output_dir", str(tmp_path)]
    if command == "sweep":
        with pytest.raises(ValueError, match="divisible by the data"):
            port_main(argv)
        assert not here
    else:
        assert port_main(argv) == 0
        assert here == [2]
    assert not started
    assert not any(tmp_path.iterdir())


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "infer"])
def test_bench_runs_through_the_kernels_on_the_card(gpu, mode):
    from cova_tpu_torch.ops import bn_pool, roi_pool

    wrappers = [roi_pool.roi_pool, bn_pool.bn_relu_pool_s2d,
                roi_pool.roi_pool_backward,
                bn_pool.bn_relu_pool_s2d_backward]
    for fn in wrappers:
        fn.launches = 0
    fn = {"train": benchmarks.run_train_bench,
          "infer": benchmarks.run_infer_bench}[mode]
    r = fn(batch_size=2, steps=2, img_height=256, windows=1, device=gpu)
    assert r["device"] == torch.cuda.get_device_name(gpu)
    launched = [f.launches > 0 for f in wrappers]
    assert launched == ([True] * 4 if mode == "train"
                        else [True, True, False, False])
