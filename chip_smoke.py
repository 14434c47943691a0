#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cova_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a GPU

Phases, each printing one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build: ``nvcc`` builds every CUDA kernel under ``cova_tpu_torch/csrc``,
   one process per source, in parallel.
3. kernels: each kernel at the shapes of its main path against its plain
   PyTorch version on the same CUDA tensors, with the kernel's and the plain
   version's times (CUDA events) and the least time the card could take
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s f32, the larger;
   published H100 SXM peaks). The forward kernels run at the serving batch
   (B = 10 pages of 1280^2, P = 232 boxes from synthetic pages with padded
   rows, bf16; roi_pool in f32 too) and must be bit-exact. The backward
   kernels run at the train batch (B = 5, P = 232) on bf16 inputs rounded
   to a coarse grid, so ties are common and the tie rules run (roi_pool in
   f32 too): dfm and dys must be bit-exact; d(scale)/d(shift), f32 sums over
   the whole map in another order, within rtol 1e-4 plus 1e-4 of their
   largest value.
4. serve: ``cova_tpu_torch.cli.main(["predict", ...])`` at full width (1280^2,
   P = 232, -cs 12, -hd 384, bf16) with a randomly initialised model from a
   seeded ``torch.Generator``, with every kernel's launch count set to 0
   just before and read just after; then one full batch is timed, and run
   again with the plain ops in place of the kernels (no kernel may launch
   then): logits must agree and the retrieval picks must be the same on
   every page.
5. train: ``cli.main(["train", ...])`` for 2 epochs on 40 synthetic pages
   at full width (the flagship defaults: -bs 5 -cs 12 -hd 384 -bbhd 32,
   bf16), with every launch count set to 0 before and read after (all four
   kernels must have launched); finite epoch losses and every artifact
   (log, imgwise/domainwise CSVs, fold_wise_acc.csv, metrics.jsonl, best and
   last checkpoints); then ``eval`` and ``predict`` from the trained
   checkpoint. Then one train step on a fixed batch is timed (ms per step,
   pages/s, peak device memory), and its gradients from one set of weights
   are compared with those of the plain (forward, backward) pairs, during
   which no kernel may launch.

Then it prints the kernels' summary line, the ``nvidia-smi`` line, and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero; without a GPU,
or outside the repo, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SEED = 123
B, IMG, P, CTX = 10, 1280, 232, 12
N_PAGES, MAX_PAGES = 100, 20  # predict serves the 20-page test split
TRAIN_B, TRAIN_PAGES = 5, 40  # the flagship train batch; a 24/8/8 split
# Kernel-vs-plain train step: every parameter gradient within GRAD_RTOL of
# its tensor's largest gradient, plus GRAD_ATOL of the model's largest
# gradient. The two runs share the forward bit for bit; in the backward,
# bf16 rounds the sums, and torch.gather's backward (scatter-add) and
# cuDNN's weight gradients add with atomics in an order that changes from
# run to run, as K6's d(scale)/d(shift) sums differ in order from the plain
# version's: a few bf16 steps (2^-8 each) at a tensor's largest entries.
# The absolute term is for gradients that are zero but for rounding (a
# Linear's bias feeding a BN), which only an absolute scale can judge.
GRAD_RTOL, GRAD_ATOL = 2e-2, 1e-6


def need(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_boxes(torch, dev, b=B):
    """Boxes and masks of b synthetic flagship pages, padded to P."""
    import numpy as np

    from cova_tpu_torch.data.records import pad_page
    from cova_tpu_torch.data.synthetic import synth_record

    pages = [
        pad_page(synth_record(str(i), IMG, np.random.default_rng((SEED, i)),
                              max_boxes=min(230, P)), P, CTX)
        for i in range(b)
    ]
    boxes = torch.from_numpy(np.stack([p.boxes_xyxy for p in pages])).to(dev)
    mask = torch.from_numpy(np.stack([p.box_mask for p in pages])).to(dev)
    return boxes, mask


def roi_work(torch, boxes, mask, h, w):
    """What RoIPool needs for these boxes: the number of map pixels that
    some valid box covers (each read once) and the sum of the bins' pixel
    counts (one max, or one compare and add, per channel per pixel per
    bin)."""
    from cova_tpu_torch.ops.roi_pool import roi_bounds

    bd = roi_bounds(boxes, mask, 0.25, 3, 3, h, w).long()
    ylo, yhi, xlo, xhi = bd[..., 0:3], bd[..., 3:6], bd[..., 6:9], bd[..., 9:12]
    areas = (yhi - ylo).clamp(min=0)[..., :, None] * (
        xhi - xlo).clamp(min=0)[..., None, :]
    y0, y1, x0, x1 = ylo[..., 0], yhi[..., 2], xlo[..., 0], xhi[..., 2]
    ok = (y1 > y0) & (x1 > x0)
    bi = torch.arange(boxes.shape[0], device=boxes.device)[:, None].expand_as(y0)
    diff = torch.zeros(boxes.shape[0], h + 1, w + 1, dtype=torch.int32,
                       device=boxes.device)
    one = ok.int()
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        diff.index_put_((bi, ys, xs), sign * one, accumulate=True)
    covered = int((diff.cumsum(1).cumsum(2)[:, :h, :w] > 0).sum())
    return covered, int(areas.sum())


def tied(torch, gen, shape, dtype, dev, levels):
    """Normal values rounded to 1/levels: many exact ties."""
    x = torch.randn(*shape, generator=gen, device=dev)
    return ((x * levels).round() / levels).to(dtype)


def phase_kernels(torch, dev):
    from cova_tpu_torch.ops.bn_pool import (
        bn_relu_pool_s2d,
        bn_relu_pool_s2d_backward,
        bn_relu_pool_s2d_backward_reference,
        bn_relu_pool_s2d_reference,
    )
    from cova_tpu_torch.ops.roi_pool import (
        roi_pool,
        roi_pool_backward,
        roi_pool_backward_reference,
        roi_pool_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    boxes, mask = synthetic_boxes(torch, dev)
    h = w = IMG // 4
    b, p = mask.shape
    covered, bin_px = roi_work(torch, boxes, mask, h, w)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        fm = torch.randn(B, h, w, 64, generator=gen, device=dev).to(dtype)
        args = (fm, boxes, mask, 0.25)
        got, want = roi_pool(*args), roi_pool_reference(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        need(err == 0.0, f"roi_pool {dtype} differs from its plain "
                         f"version by {err}")
        isz = fm.element_size()
        n_bytes = (covered * 64 * isz + b * p * 16 + b * p
                   + b * p * 9 * 64 * isz)
        n_ops = bin_px * 64
        bms, by = bound_ms(n_bytes, n_ops)
        name = "roi_pool_fwd" + ("" if dtype == torch.bfloat16 else "_f32")
        results[name] = dict(
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: roi_pool(*args), reps=20, warmup=3),
            plain_ms=cuda_ms(torch, lambda: roi_pool_reference(*args),
                             reps=2),
            bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
            valid_boxes=int(mask.sum()), shape=list(fm.shape), P=P,
            dtype=str(dtype),
        )
        del fm, got, want

    ys = torch.randn(B, h, w, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = torch.rand(64, generator=gen, device=dev) + 0.5
    shift = torch.randn(64, generator=gen, device=dev)
    got = bn_relu_pool_s2d(ys, scale, shift)
    want = bn_relu_pool_s2d_reference(ys, scale, shift)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    need(err == 0.0, f"bn_relu_pool_s2d differs from its plain version by "
                     f"{err}")
    n_out = B * h * w * 64
    n_bytes = ys.numel() * 2 + 2 * 64 * 4 + n_out * 2
    bms, by = bound_ms(n_bytes, n_out * (9 * 3 + 1))
    results["bn_relu_pool_fwd"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: bn_relu_pool_s2d(ys, scale, shift),
                   reps=20, warmup=3),
        plain_ms=cuda_ms(
            torch, lambda: bn_relu_pool_s2d_reference(ys, scale, shift),
            reps=5),
        bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_out * 28,
        shape=list(ys.shape), dtype="torch.bfloat16",
    )
    del ys, got, want

    # The backward kernels at the train batch, on tied inputs.
    boxes, mask = synthetic_boxes(torch, dev, TRAIN_B)
    b, p = mask.shape
    covered, bin_px = roi_work(torch, boxes, mask, h, w)
    for dtype in (torch.bfloat16, torch.float32):
        fm = tied(torch, gen, (b, h, w, 64), dtype, dev, 2.0)
        pooled = roi_pool_reference(fm, boxes, mask, 0.25)
        g = torch.randn(pooled.shape, generator=gen, device=dev).to(dtype)
        args = (fm, boxes, mask, pooled, g, 0.25)
        got = roi_pool_backward(*args)
        want = roi_pool_backward_reference(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        need(err == 0.0, f"roi_pool_backward {dtype} differs from its plain "
                         f"version by {err}")
        isz = fm.element_size()
        n_bytes = (covered * 64 * isz + 2 * b * p * 9 * 64 * isz
                   + b * p * 17 + fm.numel() * isz)
        n_ops = bin_px * 64 * 2
        bms, by = bound_ms(n_bytes, n_ops)
        name = "roi_pool_bwd" + ("" if dtype == torch.bfloat16 else "_f32")
        results[name] = dict(
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: roi_pool_backward(*args), reps=20,
                       warmup=3),
            plain_ms=cuda_ms(torch, lambda: roi_pool_backward_reference(
                *args), reps=1),
            bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
            valid_boxes=int(mask.sum()), shape=list(fm.shape), P=P,
            dtype=str(dtype), tied_dfm_share=float(
                (want.float().abs() > 0).float().mean()),
        )
        del fm, pooled, g, got, want, args

    ys = tied(torch, gen, (TRAIN_B, h, w, 256), torch.bfloat16, dev, 8.0)
    scale = torch.rand(64, generator=gen, device=dev) + 0.5
    shift = torch.randn(64, generator=gen, device=dev) * 0.5
    g = torch.randn(TRAIN_B, h, w, 64, generator=gen, device=dev).to(
        torch.bfloat16)
    bargs = (ys, scale, shift, g)
    got = bn_relu_pool_s2d_backward(*bargs)
    want = bn_relu_pool_s2d_backward_reference(*bargs)
    torch.cuda.synchronize()
    err = float((got[0].float() - want[0].float()).abs().max())
    need(err == 0.0, f"bn_relu_pool_s2d_backward dys differs from its plain "
                     f"version by {err}")
    sum_err = []
    for a, ref in zip(got[1:], want[1:]):
        d = float((a - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        need(bool(((a - ref).abs() <= tol + 1e-4 * ref.abs()).all()),
             f"bn_relu_pool_s2d_backward d(scale)/d(shift) differ by {d}")
        sum_err.append(d)
    n_bytes = 2 * ys.numel() * 2 + g.numel() * 2 + 2 * 64 * 4 * 2
    n_ops = ys.numel() * 8  # affine 2, tie-rule compares 3, sums 3
    bms, by = bound_ms(n_bytes, n_ops)
    results["bn_relu_pool_bwd"] = dict(
        max_abs_err=err, dscale_dshift_max_abs_err=sum_err,
        ms=cuda_ms(torch, lambda: bn_relu_pool_s2d_backward(*bargs),
                   reps=20, warmup=3),
        plain_ms=cuda_ms(
            torch, lambda: bn_relu_pool_s2d_backward_reference(*bargs),
            reps=3),
        bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
        shape=list(ys.shape), dtype="torch.bfloat16",
    )
    return results


def launch_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from cova_tpu_torch.ops import bn_pool, roi_pool

    return {"roi_pool_fwd": roi_pool.roi_pool.launches,
            "bn_relu_pool_fwd": bn_pool.bn_relu_pool_s2d.launches,
            "roi_pool_bwd": roi_pool.roi_pool_backward.launches,
            "bn_relu_pool_bwd": bn_pool.bn_relu_pool_s2d_backward.launches}


def zero_counts() -> None:
    from cova_tpu_torch.ops import bn_pool, roi_pool

    for fn in (roi_pool.roi_pool, bn_pool.bn_relu_pool_s2d,
               roi_pool.roi_pool_backward,
               bn_pool.bn_relu_pool_s2d_backward):
        fn.launches = 0


@contextlib.contextmanager
def plain_ops():
    """The model's kernel ops swapped for their plain (forward, backward)
    pairs; fails unless no kernel launched meanwhile, so a moved call site
    cannot make the plain run compare the kernels with themselves."""
    from cova_tpu_torch.models import cova as cova_mod
    from cova_tpu_torch.models import resnet as resnet_mod
    from cova_tpu_torch.ops.bn_pool import bn_relu_pool_s2d_plain
    from cova_tpu_torch.ops.roi_pool import roi_pool_plain

    before = launch_counts()
    with mock.patch.object(cova_mod, "roi_pool", roi_pool_plain), \
            mock.patch.object(resnet_mod, "bn_relu_pool_s2d",
                              bn_relu_pool_s2d_plain):
        yield
    need(launch_counts() == before,
         f"a kernel launched during the plain run: {before} -> "
         f"{launch_counts()}")


def random_state_dict(torch, cfg):
    """Full-width weights from a seeded generator: U(+-1/sqrt(fan_in)) for
    convs and linears (torch's default bound), random BN affines and
    running statistics."""
    from cova_tpu_torch.models.cova import build_model

    gen = torch.Generator().manual_seed(SEED)
    sd = build_model(cfg, device="cpu").state_dict()
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        if k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=gen) * 1.5 + 0.5
        elif v.dim() == 1:  # BN weight/bias, running_mean, linear bias
            base = 1.0 if k.endswith("weight") else 0.0
            sd[k] = base + 0.2 * (torch.rand(v.shape, generator=gen) - 0.5)
        else:
            bound = 1.0 / (v[0].numel() ** 0.5)
            sd[k] = (torch.rand(v.shape, generator=gen) * 2 - 1) * bound
    return sd


def phase_serve(torch, dev, tmp):
    import numpy as np

    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.train.steps import forward_step

    cfg = Config(img_height=IMG)  # the defaults are the flagship widths
    pth = os.path.join(tmp, "saved_model.pth")
    torch.save(random_state_dict(torch, cfg), pth)
    out_dir = os.path.join(tmp, "preds")

    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["predict", "--synthetic", str(N_PAGES), "--img_height",
                   str(IMG), "--torch_model", pth, "--out_dir", out_dir,
                   "--max_pages", str(MAX_PAGES),
                   "--output_dir", os.path.join(tmp, "results")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in launch_counts().items()
                if k.endswith("_fwd")}
    need(rc == 0, f"predict returned {rc}")
    need(all(n > 0 for n in launches.values()),
         f"a kernel was not launched on the main path: {launches}")
    files = os.listdir(out_dir)
    with open(os.path.join(out_dir, "retrieval.csv")) as f:
        n_picks = len(f.readlines()) - 1
    need(n_picks == 3 * MAX_PAGES, f"retrieval.csv has {n_picks} rows")
    need(len([f for f in files if f != "retrieval.csv"]) == MAX_PAGES,
         f"expected {MAX_PAGES} per-page CSVs, got {sorted(files)}")

    # One full batch (P = 232, no bucketing) timed with the kernels, then
    # run with the plain ops swapped in.
    model = cli.load_model(cfg, dev, pth)
    ds = InMemoryWebDataset(B, IMG, seed=SEED, max_boxes=cfg.max_boxes)
    _, batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))
    batch, _ = pad_batch(batch, B)
    need(batch.boxes.shape[1] == P, f"batch has P={batch.boxes.shape[1]}")
    out = forward_step(model, batch)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        forward_step(model, batch)
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) / reps * 1e3
    with plain_ops():
        t0 = time.perf_counter()
        plain = forward_step(model, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    mask = torch.from_numpy(batch.box_mask).to(dev)
    logits, plain_l = out.logits, plain.logits
    need(tuple(logits.shape) == (B, P, 4), f"logits {tuple(logits.shape)}")
    need(bool(torch.isfinite(logits[mask]).all()), "non-finite logits")
    diff = float((logits - plain_l)[mask].abs().max())
    neg = torch.tensor(float("-inf"), device=dev)
    picks = [torch.where(mask[..., None], lg, neg).argmax(1)[:, 1:]
             for lg in (logits, plain_l)]
    agree = float((picks[0] == picks[1]).float().mean())
    # The two ops are bit-exact, so any difference comes from the rest of
    # the forward; 0.05 is a few bf16 steps at logits of order 1.
    need(diff <= 0.05, f"kernel and plain logits differ by {diff}")
    need(agree == 1.0, f"retrieval picks agree on {agree:.1%} only")
    return launches, dict(
        predict_wall_s=wall, pages=MAX_PAGES, ms_per_batch=ms_batch,
        pages_per_s=B / (ms_batch / 1e3), batch=B, P=P,
        plain_ops_batch_s=plain_s, logits_max_abs_diff_vs_plain=diff,
        pick_agreement=agree, n_boxes_valid=int(np.asarray(
            batch.box_mask).sum()),
    )


def fixed_train_batch(cfg):
    """One flagship train batch (B = 5, BG subsampled as in training) at
    the full P = 232."""
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_pipelines
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset

    ds = InMemoryWebDataset(TRAIN_B, IMG, seed=SEED + 1,
                            max_boxes=cfg.max_boxes)
    train_p, _, _ = make_pipelines(cfg, ds, ds, ds)
    _, batch = next(iter(train_p.epoch(1)))
    return pad_batch(batch, TRAIN_B)[0]


def step_grads(torch, model, sd, batch, seed):
    """Loss and parameter gradients of one training forward/backward from
    the weights ``sd`` (dropout from a generator seeded with ``seed``)."""
    from cova_tpu_torch.train.steps import (
        _to_device,
        batch_to_device,
        masked_ce_sum,
    )

    model.load_state_dict(sd)
    model.train()
    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = model(**batch_to_device(batch, dev), generator=gen)
    loss = masked_ce_sum(out.logits, _to_device(batch.labels, dev),
                         _to_device(batch.box_mask, dev))
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}


def grad_diff(a, b):
    """Gradients ``a`` against ``b``: the largest share of its tolerance
    any tensor uses (<= 1 passes) and that tensor, and the largest
    difference relative to the tensor's largest gradient among the tensors
    above the absolute floor."""
    g = max(float(v.abs().max()) for v in b.values())
    share, worst, rel = 0.0, "", 0.0
    for k in b:
        top = float(b[k].abs().max())
        d = float((a[k] - b[k]).abs().max())
        s = d / (GRAD_RTOL * top + GRAD_ATOL * g)
        if s > share:
            share, worst = s, k
        if top > GRAD_ATOL * g:
            rel = max(rel, d / top)
    return dict(share_of_tolerance=share, worst_tensor=worst,
                max_rel_diff=rel)


def phase_train(torch, dev, tmp):
    import numpy as np

    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import create_train_state, train_step

    out = os.path.join(tmp, "train_results")
    common = ["--synthetic", str(TRAIN_PAGES), "--img_height", str(IMG),
              "--output_dir", out]
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", *common, "-e", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(rc == 0, f"train returned {rc}")
    need(all(n > 0 for n in launches.values()),
         f"a kernel was not launched on the train path: {launches}")

    cfg = Config(img_height=IMG)  # the flagship defaults of the CLI
    res = os.path.join(out, cfg.params_key)
    for name in ("Fold-1 logs.txt", "Fold-1 test_acc_imgwise.csv",
                 "Fold-1 test_acc_domainwise.csv", "fold_wise_acc.csv",
                 "metrics.jsonl", "Fold-1 saved_model.pt/best.pt",
                 "Fold-1 saved_model.pt/last.pt"):
        need(os.path.isfile(os.path.join(res, name)), f"train wrote no "
                                                       f"{name!r}")
    with open(os.path.join(res, "Fold-1 logs.txt")) as f:
        losses = [float(line.split("Loss:")[1].split()[0])
                  for line in f if line.startswith("Epoch:")]
    need(len(losses) == 2 and all(np.isfinite(losses)),
         f"epoch losses {losses}")

    cwd = os.getcwd()
    os.chdir(tmp)  # eval writes its reports into the working directory
    try:
        rc = cli.main(["eval", *common])
    finally:
        os.chdir(cwd)
    need(rc == 0 and os.path.isfile(os.path.join(
        tmp, "Fold-1 test_acc_imgwise.csv")), f"eval returned {rc}")
    preds = os.path.join(tmp, "train_preds")
    rc = cli.main(["predict", *common, "--out_dir", preds])
    need(rc == 0 and os.path.isfile(os.path.join(preds, "retrieval.csv")),
         f"predict from the trained checkpoint returned {rc}")

    # One train step on a fixed batch, timed; peak memory over the window.
    batch = fixed_train_batch(cfg)
    need(batch.boxes.shape[1] == P, f"train batch has P={batch.boxes.shape[1]}")
    state = create_train_state(build_model(cfg, device=dev), cfg)
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for _ in range(2):
        train_step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        m = train_step(state, batch, gen)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    need(np.isfinite(float(m["loss_sum"])), "non-finite train loss")

    # Gradients from the same weights and batch: kernels twice (the
    # run-to-run spread), then the plain pairs.
    model = state.model
    loss_k, grads_k = step_grads(torch, model, sd, batch, SEED)
    loss_k2, grads_k2 = step_grads(torch, model, sd, batch, SEED)
    with plain_ops():
        t0 = time.perf_counter()
        loss_p, grads_p = step_grads(torch, model, sd, batch, SEED)
        plain_s = time.perf_counter() - t0
    loss_diff = abs(loss_k - loss_p)
    need(loss_diff <= 1e-5 * abs(loss_p),
         f"kernel and plain train losses {loss_k} vs {loss_p}")
    vs_plain = grad_diff(grads_k, grads_p)
    need(vs_plain["share_of_tolerance"] <= 1.0,
         f"kernel and plain gradients differ beyond the tolerance: "
         f"{vs_plain}")
    return launches, dict(
        train_wall_s=wall, epoch_losses=losses, pages=TRAIN_PAGES,
        ms_per_step=ms_step, pages_per_s=TRAIN_B / (ms_step / 1e3),
        batch=TRAIN_B, P=P, peak_memory_bytes=peak,
        n_boxes_valid=int(np.asarray(batch.box_mask).sum()),
        loss_kernel=loss_k, loss_plain=loss_p, loss_abs_diff=loss_diff,
        grad_vs_plain=vs_plain,
        grad_kernel_rerun=grad_diff(grads_k2, grads_k),
        grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL, plain_step_s=plain_s,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cova_tpu_torch.ops import _build  # fails outside the repo

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    reports = _build.build()
    ptxas = [line.strip() for log in reports.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(reports), "ptxas": ptxas})

    kernels = phase_kernels(torch, dev)
    emit({"phase": "kernels", "names": sorted(kernels), "results": kernels})

    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, serve = phase_serve(torch, dev, tmp)
    emit({"phase": "serve", "launches": serve_launches, **serve})

    with tempfile.TemporaryDirectory() as tmp:
        launches, train = phase_train(torch, dev, tmp)
    emit({"phase": "train", "launches": launches, **train})

    # Launches: the train path's run (this slice's main path), which runs
    # all four; the serve phase's counts are in its own line.
    meta = {
        "roi_pool_fwd": ("cova_tpu_torch/csrc/roi_pool.cu",
                         "cova_tpu/ops/roi_pool_pallas.py:215"),
        "bn_relu_pool_fwd": ("cova_tpu_torch/csrc/bn_pool.cu",
                             "cova_tpu/ops/bn_pool.py:75"),
        "roi_pool_bwd": ("cova_tpu_torch/csrc/roi_pool.cu",
                         "cova_tpu/ops/roi_pool_pallas.py:521"),
        "bn_relu_pool_bwd": ("cova_tpu_torch/csrc/bn_pool.cu",
                             "cova_tpu/ops/bn_pool.py:102"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"], "library_ms": None}
        for name, (src, rep) in meta.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
