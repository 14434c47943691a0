"""The training host-data modules of the port: the decoded-screenshot cache
against the JAX package's (same file names, same bytes, either package
reads the other's), and the device prefetcher on the CPU."""

import glob
import os

import numpy as np
import pytest

from cova_tpu.data import native_loader as jax_native_loader
from cova_tpu.data.dataset import WebDataset as JaxWebDataset
from cova_tpu.data.pipeline import DataPipeline as JaxPipeline
from cova_tpu.data.synthetic import materialize
from cova_tpu_torch import cli
from cova_tpu_torch.data import native_loader
from cova_tpu_torch.data.dataset import WebDataset
from cova_tpu_torch.data.device_prefetch import device_prefetch
from cova_tpu_torch.data.pipeline import DataPipeline
from cova_tpu_torch.data.synthetic import InMemoryWebDataset

PIPE = dict(batch_size=2, pad_boxes=16, context_size=2, seed=5,
            num_threads=2)


def _native_or_skip():
    """Build the port's native library (race-free) or skip where no C++
    toolchain with libpng exists; the JAX package's decoder loads the same
    build, so both sides decode natively."""
    if not native_loader.ensure_built():
        pytest.skip("no C++ toolchain with libpng for native/cova_native.cpp")
    assert jax_native_loader.load_library(native_loader.lib_path())


def _entries(cache_dir):
    """{file name relative to the cache dir: bytes}."""
    out = {}
    for path in glob.glob(os.path.join(cache_dir, "*", "*")):
        with open(path, "rb") as f:
            out[os.path.relpath(path, cache_dir)] = f.read()
    return out


@pytest.fixture()
def pages(tmp_path):
    root = str(tmp_path / "data")
    ids = materialize(root, 7, 32, seed=3, min_boxes=4, max_boxes=8)
    return root, ids


@pytest.mark.parametrize("native", [True, False])
def test_decode_cache_files_equal_the_jax_packages(pages, tmp_path, native):
    """One epoch of either package's pipeline over the same pages writes
    the same cache entries, name for name and byte for byte; a second epoch
    reads them back and yields the same batches."""
    if native:
        _native_or_skip()
    root, ids = pages
    dirs = {k: str(tmp_path / k) for k in ("port", "jax")}
    port = DataPipeline(WebDataset(root, ids, img_size=32, use_native=native,
                                   decode_cache_dir=dirs["port"]), **PIPE)
    ref = JaxPipeline(JaxWebDataset(root, ids, img_size=32,
                                    use_native=native,
                                    decode_cache_dir=dirs["jax"]), **PIPE)
    first = list(port.epoch(0))
    list(ref.epoch(0))
    got, want = _entries(dirs["port"]), _entries(dirs["jax"])
    assert len(want) == len(ids) and sorted(got) == sorted(want)
    tag = "s2d4-32" if native else "raw-32"
    assert all(name.endswith(f".{tag}.npy") for name in got)
    for name in want:
        assert got[name] == want[name], name
    mtimes = {p: os.path.getmtime(p)
              for p in glob.glob(os.path.join(dirs["port"], "*", "*"))}
    second = list(port.epoch(0))
    for (ids_a, a), (ids_b, b) in zip(first, second):
        assert ids_a == ids_b
        for f, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(x, y, err_msg=f)
    # The second epoch read the entries: none was written again.
    assert mtimes == {p: os.path.getmtime(p) for p in mtimes}


def test_either_package_reads_the_others_cache(pages, tmp_path):
    """The port, pointed at a cache the JAX package wrote, decodes nothing:
    with the PNGs' pixels changed behind the cache's back (same mtime), it
    still yields the cached images."""
    root, ids = pages
    cache = str(tmp_path / "shared")
    ref = JaxWebDataset(root, ids, img_size=32, use_native=False,
                        decode_cache_dir=cache)
    want = [ref.image(i) for i in range(len(ids))]
    for path in ref.img_paths:  # blank the sources, keeping their mtimes
        st = os.stat(path)
        from PIL import Image

        Image.new("RGB", (32, 32)).save(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    port = WebDataset(root, ids, img_size=32, use_native=False,
                      decode_cache_dir=cache)
    for i, w in enumerate(want):
        assert w.any()
        np.testing.assert_array_equal(port.image(i), w)
    # A source newer than its entry is decoded again.
    os.utime(ref.img_paths[0])
    assert not port.image(0).any()


def test_cli_decode_cache_runs(pages, tmp_path, monkeypatch):
    """``cli train --decode_cache`` on on-disk pages writes one entry per
    page of the fold and trains."""
    monkeypatch.delenv("COVA_DECODE_CACHE", raising=False)
    root, ids = pages
    fold = tmp_path / "splits" / "Fold-1"
    fold.mkdir(parents=True)
    for name, part in (("train", ids[:3]), ("val", ids[3:5]),
                       ("test", ids[5:])):
        (fold / f"{name}_imgs.txt").write_text("\n".join(part) + "\n")
    cache = str(tmp_path / "dc")
    rc = cli.main(["train", "--data_dir", root, "--split_dir",
                   str(tmp_path / "splits"), "--img_height", "32", "-cs",
                   "2", "-hd", "16", "-bbhd", "4", "--compute_dtype",
                   "float32", "-nw", "2", "--device", "cpu", "-e", "2", "-bs",
                   "2", "--output_dir", str(tmp_path / "out"),
                   "--decode_cache", cache])
    assert rc == 0
    assert len(glob.glob(os.path.join(cache, "*", "*.npy"))) == len(ids)


def _pipe():
    ds = InMemoryWebDataset(7, 32, seed=3, min_boxes=4, max_boxes=12)
    return DataPipeline(ds, **PIPE)


def test_prefetcher_on_the_cpu_passes_batches_through():
    """In order, byte for byte, with the host batch handed on as it is."""
    want = list(_pipe().epoch(0))
    got = list(device_prefetch(_pipe().epoch(0), "cpu"))
    assert len(got) == len(want) == 4
    for (ids, batch, on_device), (ids_w, batch_w) in zip(got, want):
        assert ids == ids_w and on_device is batch
        for f, x, y in zip(batch._fields, batch, batch_w):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_prefetcher_ends_cleanly_when_the_consumer_stops_early():
    """Closing the prefetcher closes the pipeline's generator, whose
    producer thread then exits."""
    import threading

    before = threading.active_count()
    closed = []

    def source():
        try:
            yield from _pipe().epoch(0)
        finally:
            closed.append(True)

    gen = device_prefetch(source(), "cpu")
    next(gen)
    gen.close()
    assert closed == [True]
    for t in threading.enumerate():
        if t is not threading.main_thread():
            t.join(timeout=5)
    assert threading.active_count() <= before


def test_steps_take_prefetched_tensors():
    """``train_step`` and ``eval_step`` accept a batch of tensors (what the
    prefetcher yields on a GPU) and give what they give for host arrays."""
    import torch

    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import Batch
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import eval_step

    cfg = Config(img_height=32, max_boxes=16, context_size=2, hidden_dim=16,
                 bbox_hidden_dim=4, compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    _, batch = next(iter(_pipe().epoch(0)))
    tensors = Batch(*(torch.from_numpy(np.ascontiguousarray(a))
                      for a in batch))
    a, b = eval_step(model, batch), eval_step(model, tensors)
    assert torch.equal(a["logits"], b["logits"])
    assert torch.equal(a["correct"], b["correct"])
