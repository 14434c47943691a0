"""Throughput benchmarks of the port: the train step, the serving forward
and the pipeline-fed train epoch, in pages/s.

Counterpart of ``cova_tpu/benchmarks.py`` with the same arguments, defaults
and returned JSON keys, plus ``device`` (``cuda`` by default). The
torch-CPU anchors that ``vs_baseline`` divides by are the repository's
``baseline_torch.json`` and ``baseline_torch_infer.json``.

Timing, as the JAX package's benches measure it:

  * the train and infer benches stage one batch on the device and time
    ``steps`` calls of ``train_step`` (or ``forward_step``, eval mode) per
    window on the host clock; each window ends in
    ``torch.cuda.synchronize()``, one untimed window warms up first, and
    the best of ``windows`` is kept (host noise is additive);
  * the e2e bench times whole epochs fed by ``DataPipeline`` through
    ``data.device_prefetch``, as the trainer feeds them, after one warm
    epoch and two warm steps at every bucket shape (the first runs eagerly,
    the second captures the step's graph).

The steps run through CUDA graphs on a CUDA device (``train/graphs.py``:
one graph per shape, as the JAX package's ``jax.jit``), or eagerly with
``graphs=False``, which is how one process times both sides. The JAX
benches run their steps inside one jitted loop that needs a carry to
defeat loop-invariant hoisting; a replayed graph needs none. Two parts of them
are left out on purpose: the VMEM compile-OOM fallback (the port's kernels
raise when a shape does not fit, ``ops/vmem_fallback`` has no counterpart)
and the three-attempt retry after a failed first dispatch (it served a
remote TPU link; here a failure surfaces).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .config import Config
from .data.batching import (
    Batch,
    bucket_batch,
    collate,
    pad_batch,
    slice_boxes,
)
from .data.records import pad_page
from .data.synthetic import synth_image, synth_record

TRAIN_SEED, INFER_SEED = 7, 11  # page i of a bench batch: rng((seed, i))


def _vs_baseline(pages_per_sec, baseline_file, img_height):
    """pages_per_sec over the measured torch-CPU anchor; None when the
    anchor is missing or was measured at another image geometry (both
    sides are per page, so the batch size need not match)."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        baseline_file,
    )
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        base = json.load(f)
    if not base.get("value"):
        return None
    if base.get("geometry", {}).get("img") != img_height:
        return None
    return pages_per_sec / base["value"]


def bench_config(batch_size, img_height, compute_dtype, use_additional_feat,
               backbone="resnet18_stem", context_size=12) -> Config:
    # With --use_additional_feat the pages carry 4 synthetic features, as
    # the CLI's synthetic path.
    return Config(
        batch_size=batch_size,
        img_height=img_height,
        compute_dtype=compute_dtype,
        use_additional_feat=use_additional_feat,
        n_additional_feat=4 if use_additional_feat else 0,
        backbone=backbone,
        context_size=context_size,
    )


def bench_batch(cfg: Config, seed: int) -> Batch:
    """The benches' host batch of ``cfg.batch_size`` pages: page i drawn
    from ``np.random.default_rng((seed, i))`` with 60..min(120,
    max_boxes) boxes (the real data's mean is 93), padded, collated and
    sliced to its box bucket, as the trainer and eval dispatch it."""
    imgs, pages = [], []
    for i in range(cfg.batch_size):
        rng = np.random.default_rng((seed, i))
        rec = synth_record(str(i), cfg.img_height, rng, min_boxes=60,
                           max_boxes=min(120, cfg.max_boxes),
                           n_additional_feat=cfg.n_additional_feat)
        imgs.append(synth_image(rec, cfg.img_height, rng))
        pages.append(pad_page(rec, cfg.pad_boxes, cfg.context_size,
                              n_additional_feat=cfg.n_additional_feat))
    return bucket_batch(collate(imgs, pages), cfg.box_buckets)


def _first_boxes(batch: Batch, t: int) -> Batch:
    """Every page cut to its first ``t`` box rows, with context slots that
    pointed past them made padding (-1): a valid batch at box dim ``t``."""
    cut = slice_boxes(batch, t)
    ctx = cut.context_indices
    return cut._replace(context_indices=np.where(ctx < t, ctx, -1)
                        .astype(ctx.dtype))


def stage_batch(batch: Batch, device) -> Batch:
    """The batch as tensors on ``device``, copied once."""
    return Batch(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in batch))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _best_step_seconds(fn, steps: int, windows: int, device) -> float:
    """Seconds per call of ``fn``: the best of ``windows`` windows of
    ``steps`` calls each, after one untimed window."""
    for _ in range(steps):
        fn()
    _sync(device)
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def run_train_bench(
    batch_size: int = 8,
    steps: int = 20,
    img_height: int = 1280,
    compute_dtype: str = "bfloat16",
    windows: int = 3,
    use_additional_feat: bool = False,
    backbone: str = "resnet18_stem",
    context_size: int = 12,
    device="cuda",
    graphs: bool = True,
):
    """Training throughput: forward, backward and the Adam update on a
    batch staged on the device (``graphs``: through the step's CUDA
    graph)."""
    from .models.cova import build_model
    from .train.steps import create_train_state, train_step

    device = torch.device(device)
    cfg = bench_config(batch_size, img_height, compute_dtype,
                       use_additional_feat, backbone, context_size)
    batch = stage_batch(bench_batch(cfg, TRAIN_SEED), device)
    state = create_train_state(build_model(cfg, device=device), cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    best_dt = _best_step_seconds(
        lambda: train_step(state, batch, gen, graphs=graphs), steps, windows,
        device)
    pages_per_sec = batch_size / best_dt
    vs_baseline = _vs_baseline(pages_per_sec, "baseline_torch.json",
                               img_height)
    return {
        "metric": "train_webpages_per_sec_per_chip",
        "value": round(pages_per_sec, 2),
        "unit": "pages/s",
        "vs_baseline": (
            round(vs_baseline, 1) if vs_baseline is not None else None
        ),
        "step_ms": round(best_dt * 1000, 2),
        "batch_size": batch_size,
        "img_height": img_height,
        "compute_dtype": compute_dtype,
        "use_additional_feat": use_additional_feat,
        "backbone": backbone,
        "context_size": context_size,
        "device": _device_name(device),
    }


def run_e2e_bench(
    batch_size: int = 8,
    n_pages: int = 64,
    epochs: int = 3,
    img_height: int = 1280,
    compute_dtype: str = "bfloat16",
    num_threads: int = 0,
    source: str = "mem",
    use_additional_feat: bool = False,
    device="cuda",
    graphs: bool = True,
):
    """Pipeline-fed training throughput: batches flow from ``DataPipeline``
    (BG sampling, context build, padded collation) through
    ``device_prefetch`` into ``train_step``, the rate a training run
    sustains on this host, beside ``run_train_bench``'s device-staged one.

    ``source``: ``mem`` feeds an in-memory synthetic dataset (host cost =
    page building + collate); ``disk`` writes PNGs and CSVs in the
    reference layout and feeds them through the native decode path with
    the decoded-screenshot cache, so the timed epochs are cache-warm (the
    steady state of a multi-epoch run).
    """
    from .data.device_prefetch import device_prefetch
    from .data.pipeline import DataPipeline
    from .data.synthetic import InMemoryWebDataset
    from .models.cova import build_model
    from .train.steps import create_train_state, train_step

    device = torch.device(device)
    cfg = bench_config(batch_size, img_height, compute_dtype,
                       use_additional_feat)
    threads = num_threads or min(8, os.cpu_count() or 1)
    tmpdir = None
    try:
        if source == "disk":
            import tempfile

            from .data.dataset import WebDataset
            from .data.synthetic import materialize

            tmpdir = tempfile.TemporaryDirectory(prefix="cova_e2e_disk_")
            ids = materialize(
                f"{tmpdir.name}/data", n_pages, img_height, seed=7,
                min_boxes=11, max_boxes=cfg.max_boxes,
                n_additional_feat=cfg.n_additional_feat,
            )
            ds = WebDataset(
                f"{tmpdir.name}/data", ids, use_additional_feat,
                img_size=img_height,
                decode_cache_dir=f"{tmpdir.name}/cache",
            )
        else:
            ds = InMemoryWebDataset(
                n_pages, img_height, seed=7, max_boxes=cfg.max_boxes,
                n_additional_feat=cfg.n_additional_feat,
            )
        pipe = DataPipeline(
            ds,
            batch_size=batch_size,
            pad_boxes=cfg.pad_boxes,
            context_size=cfg.context_size,
            shuffle=True,
            sampling_fraction=cfg.sampling_fraction,
            seed=cfg.seed,
            num_threads=threads,
        )
        _, example = next(iter(pipe.epoch(0)))
        example, _ = pad_batch(example, batch_size)
        state = create_train_state(build_model(cfg, device=device), cfg)
        gen = torch.Generator(device=device).manual_seed(1)

        def one_epoch(epoch):
            # The trainer's dispatch: pad to the static batch, then slice
            # the box dim to its bucket.
            padded = (
                (ids, bucket_batch(pad_batch(b, batch_size)[0],
                                   cfg.box_buckets))
                for ids, b in pipe.epoch(epoch=epoch)
            )
            m = None
            for _, _, on_device in device_prefetch(padded, device, size=2):
                m = train_step(state, on_device, gen, graphs=graphs)
            float(m["loss_sum"])  # the epoch ends when the device is done

        one_epoch(0)
        # Two steps at every bucket shape the trainer could dispatch, so no
        # first use of a shape (kernel plans, allocator growth, the graph's
        # eager step and its capture) falls in the timed epochs: a bucket
        # can first appear in any epoch.
        p_full = example.boxes.shape[1]
        for t in sorted({b for b in cfg.box_buckets if b < p_full}
                        | {p_full}):
            for _ in range(2):
                train_step(state, _first_boxes(example, t), gen,
                           graphs=graphs)
        _sync(device)
        t0 = time.perf_counter()
        for e in range(1, epochs + 1):
            one_epoch(e)
        dt = (time.perf_counter() - t0) / epochs
    finally:
        # A failed run must not leave the materialized pages and the
        # decode cache behind.
        if tmpdir is not None:
            tmpdir.cleanup()
    e2e_pages_per_sec = n_pages / dt
    compute = run_train_bench(
        batch_size=batch_size,
        img_height=img_height,
        compute_dtype=compute_dtype,
        use_additional_feat=use_additional_feat,
        device=device,
        graphs=graphs,
    )
    return {
        "metric": "e2e_train_webpages_per_sec",
        "value": round(e2e_pages_per_sec, 2),
        "unit": "pages/s",
        "source": source,
        "use_additional_feat": use_additional_feat,
        "epoch_seconds": round(dt, 2),
        "host_threads": threads,
        "compute_pages_per_sec": compute["value"],
        "compute_step_ms": compute["step_ms"],
        "batch_size": batch_size,
        "img_height": img_height,
        "compute_dtype": compute_dtype,
        "device": compute["device"],
    }


def run_infer_bench(
    batch_size: int = 32,
    steps: int = 20,
    img_height: int = 1280,
    compute_dtype: str = "bfloat16",
    windows: int = 3,
    use_additional_feat: bool = False,
    backbone: str = "resnet18_stem",
    context_size: int = 12,
    device="cuda",
    graphs: bool = True,
):
    """Serving throughput: the eval-mode forward (running BN statistics,
    no optimizer state) with logits for every box of the page, on a batch
    staged on the device (``graphs``: through the forward's CUDA graph)."""
    from .models.cova import build_model
    from .train.steps import forward_step

    device = torch.device(device)
    cfg = bench_config(batch_size, img_height, compute_dtype,
                       use_additional_feat, backbone, context_size)
    batch = stage_batch(bench_batch(cfg, INFER_SEED), device)
    model = build_model(cfg, device=device).eval()
    best_dt = _best_step_seconds(
        lambda: forward_step(model, batch, graphs=graphs), steps, windows,
        device)
    pages_per_sec = batch_size / best_dt
    vs_baseline = _vs_baseline(pages_per_sec, "baseline_torch_infer.json",
                               img_height)
    return {
        "metric": "infer_webpages_per_sec_per_chip",
        "value": round(pages_per_sec, 2),
        "unit": "pages/s",
        "vs_baseline": (
            round(vs_baseline, 1) if vs_baseline is not None else None
        ),
        "step_ms": round(best_dt * 1000, 2),
        "batch_size": batch_size,
        "img_height": img_height,
        "compute_dtype": compute_dtype,
        "use_additional_feat": use_additional_feat,
        "backbone": backbone,
        "context_size": context_size,
        "device": _device_name(device),
    }
