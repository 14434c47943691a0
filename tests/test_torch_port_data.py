"""The port's host data layer yields the JAX package's batches byte for
byte, for the same seed: synthetic pages in memory (easy and hard mode) and
materialized pages read from disk (native decode and PIL)."""

import numpy as np
import pytest

from cova_tpu.data import native_loader as jax_native_loader
from cova_tpu.data import records as jax_records
from cova_tpu.data.batching import bucket_batch as jax_bucket
from cova_tpu.data.batching import pad_batch as jax_pad_batch
from cova_tpu.data.dataset import WebDataset as JaxWebDataset
from cova_tpu.data.pipeline import DataPipeline as JaxPipeline
from cova_tpu.data.synthetic import InMemoryWebDataset as JaxMemDS
from cova_tpu.data.synthetic import materialize
from cova_tpu_torch.data import native_loader
from cova_tpu_torch.data import records
from cova_tpu_torch.data.batching import bucket_batch, pad_batch
from cova_tpu_torch.data.dataset import WebDataset
from cova_tpu_torch.data.pipeline import DataPipeline
from cova_tpu_torch.data.synthetic import InMemoryWebDataset
from cova_tpu_torch.data.synthetic import materialize as port_materialize

PIPE = dict(batch_size=3, pad_boxes=24, context_size=3, seed=5,
            num_threads=2)


def _native_or_skip():
    """Build the port's native library (race-free) or skip where no C++
    toolchain with libpng exists; the JAX package's decoder loads the same
    build, so both sides decode natively."""
    if not native_loader.ensure_built():
        pytest.skip("no C++ toolchain with libpng for native/cova_native.cpp")
    assert jax_native_loader.load_library(native_loader.lib_path())


def _assert_same_epochs(port_pipe, jax_pipe, epochs=(0, 1)):
    for ep in epochs:
        got = list(port_pipe.epoch(ep))
        want = list(jax_pipe.epoch(ep))
        assert len(got) == len(want) > 0
        for (ids, b), (ids_j, b_j) in zip(got, want):
            assert ids == ids_j
            for f, g, w in zip(b._fields, b, b_j):
                assert g.dtype == w.dtype, f
                np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("train_style", [False, True])
def test_synthetic_batches_byte_identical(hard, train_style):
    kw = dict(n_pages=7, img_h=32, seed=3, min_boxes=5, max_boxes=20,
              n_additional_feat=2 if hard else 0, hard=hard)
    opts = dict(shuffle=True, sampling_fraction=0.7) if train_style else {}
    _assert_same_epochs(
        DataPipeline(InMemoryWebDataset(**kw), **PIPE, **opts),
        JaxPipeline(JaxMemDS(**kw), **PIPE, **opts),
    )


@pytest.fixture(scope="module")
def disk_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pages"))
    ids = materialize(root, n_pages=5, img_h=32, seed=4, min_boxes=5,
                      max_boxes=20, n_additional_feat=3)
    return root, ids


@pytest.mark.parametrize("native", [True, False])
def test_disk_batches_byte_identical(disk_root, native):
    if native:
        _native_or_skip()
    root, ids = disk_root
    kw = dict(use_additional_feats=True, img_size=32, use_native=native)
    port_ds = WebDataset(root, ids, **kw)
    assert port_ds.use_native == native
    _assert_same_epochs(
        DataPipeline(port_ds, **PIPE),
        JaxPipeline(JaxWebDataset(root, ids, **kw), **PIPE),
        epochs=(0,),
    )


def test_materialize_writes_the_same_files(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_materialize(a, 3, 16, seed=9, max_boxes=12) == materialize(
        b, 3, 16, seed=9, max_boxes=12
    )
    for sub, name in (("imgs", "1.png"), ("bboxes", "2.csv")):
        with open(f"{a}/{sub}/{name}", "rb") as fa, \
                open(f"{b}/{sub}/{name}", "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("n,k", [(0, 2), (1, 3), (5, 2), (30, 12)])
def test_records_match_jax(n, k):
    np.testing.assert_array_equal(
        records.build_context_indices(n, k),
        jax_records.build_context_indices(n, k),
    )
    rng = np.random.default_rng(n)
    rec = records.PageRecord(
        "p", rng.random((n, 4)).astype(np.float32),
        rng.integers(0, 4, n).astype(np.int32),
    )
    jrec = jax_records.PageRecord(rec.page_id, rec.boxes_xywh, rec.labels)
    got = records.pad_page(rec, 32, k)
    want = jax_records.pad_page(jrec, 32, k)
    for f in ("boxes_xyxy", "labels", "box_mask", "context_indices",
              "additional_feats"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_pad_and_bucket_batch_match_jax():
    ds = InMemoryWebDataset(n_pages=5, img_h=16, seed=2, min_boxes=3,
                            max_boxes=20)
    batches = list(DataPipeline(ds, **PIPE).epoch(0))
    _, last = batches[-1]  # a partial batch of 2 pages
    got, page_mask = pad_batch(last, 4)
    want, page_mask_j = jax_pad_batch(last, 4)
    np.testing.assert_array_equal(page_mask, page_mask_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(bucket_batch(got, (8, 16)), jax_bucket(want, (8, 16))):
        np.testing.assert_array_equal(g, w)
