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
   rows), in bf16 and f32, and must be bit-exact. The backward kernels run
   at the train batch (B = 5, P = 232) on inputs rounded to a coarse grid,
   so ties are common and the tie rules run, in bf16 and f32: dfm and dys
   must be bit-exact; d(scale)/d(shift), f32 sums over the whole map in
   another order, within rtol 1e-4 plus 1e-4 of their largest value. Every
   pool kernel is also held, bit-exact, at ragged shapes in bf16 and f32
   (ROI_RAGGED for the RoIPool forward and backward, the backward once more
   with a pair list so small that its tiles walk several lists; BN_RAGGED
   for the stem pool backward; BN_FWD_RAGGED for its forward, from an
   aligned ys and from one 8 bytes past a 16-byte boundary), and timed ten
   times each in a row at the flagship shape, with every timing, the
   spread, the achieved GB/s and the bound's share of the time. K1's line
   adds how often its bins re-read a covered pixel, its largest bin, and
   the time of the bin bounds by their kernel (K3's first launch, on the
   rule K1 applies in its own kernel; held bit for bit against
   ``roi_bounds`` at every shape) and by the plain PyTorch chain; K3's adds
   the (box, bin) pairs its tiles list (mean, largest, share of empty
   tiles). The build line lists the pool kernels' registers and spills and
   what ``cuobjdump -sass`` shows of the K5 and K3 kernels (instructions,
   CALLs, 64-bit division routines).
4. serve: ``cova_tpu_torch.cli.main(["predict", ...])`` at full width (1280^2,
   P = 232, -cs 12, -hd 384, bf16) with a randomly initialised model from a
   seeded ``torch.Generator``, with every kernel's launch count set to 0
   just before and read just after; then one full batch is timed, and run
   again with the plain ops in place of the kernels (no kernel may launch
   then): logits must agree and the retrieval picks must be the same on
   every page.
5. train: ``cli.main(["train", ...])`` for 2 epochs on 40 synthetic pages
   at full width (the flagship defaults: -bs 5 -cs 12 -hd 384 -bbhd 32,
   bf16), with every launch count set to 0 before and read after (the four
   kernels of the default path must have launched, the conv kernels not);
   finite epoch losses and every artifact
   (log, imgwise/domainwise CSVs, fold_wise_acc.csv, metrics.jsonl, best and
   last checkpoints); then ``eval`` and ``predict`` from the trained
   checkpoint. Then one train step on a fixed batch is timed (ms per step,
   pages/s, peak device memory), and its gradients from one set of weights
   are compared with those of the plain (forward, backward) pairs, during
   which no kernel may launch.

6. conv_kernels: the two 3x3 conv kernels (input-stationary ``conv3x3``,
   output-stationary ``conv3x3_roll``) against the plain nine-product
   version, bf16 and f32, at small ragged shapes (H != W, 48 -> 256 channels
   and its transpose, 64 -> 64; widths 7, 63, 64, 65 and 129 and heights
   that cross the bf16 kernels' 8-, 16- and 64-pixel tile edges; B = 3;
   128 -> 128 and 512 -> 512, where the bf16 kernels stream their weights
   instead of keeping them in shared memory) and at the model's shapes at
   B = 10 ([10, 320, 320, 64] -> 64 and the stem's [10, 320, 320, 48] ->
   256), with ``conv3x3``'s dx and dW against the plain pair; bf16 within
   2^-7 of the largest output, f32 within 1e-5 of it, with the share of
   elements that are not bit-equal (f32 at the model's shapes also beside
   a float64 conv: max and rms error of each kernel, the plain version and
   cuDNN); ten timings each (median and spread) beside the plain
   version's, ``F.conv2d``'s (cuDNN, TF32 off), the kernels' that these
   replaced (bf16: wmma; f32: FMAs) and the bound
   (989 TFLOP/s bf16; f32 the lesser of two routes, 67 TFLOP/s of FMAs or
   three passes at 494.7 TFLOP/s TF32; 3.35 TB/s), with the achieved
   TFLOP/s and the bound's share of the time. The build line lists the
   conv kernels' registers and spills, and any wgmma ptxas serialized.
7. conv: with ``COVA_CUDA_CONV=1``, one B = 10 batch served and ``cli
   train`` for one epoch at B = 5, at full width; ``conv3x3`` must launch 5
   times per forward and 4 more per backward and ``F.conv2d`` must run no
   3x3 stride-1 conv meanwhile; logits and retrieval picks are held
   against the opt-in-off run from the same weights, and one step's
   gradients against the plain nine-product conv's (f32, at the train
   phase's tolerance) and within cuDNN's own distance from it (f32 and
   bf16; see the note in ``phase_conv``), and in f32 each conv's distance
   from a float64 conv's gradients (reported); then ``conv3x3``,
   ``conv3x3_roll`` and cuDNN on a served feature map.
8. backbones: the full ``resnet18`` under the opt-in (the kernel at 128,
   256 and 512 channels) and ``resnet50_stem`` with and without
   ``COVA_REMAT=1``, at 640^2 and B = 2: logits against the plain-op path,
   train steps, peak memory; ``resnet18``'s four steps also run a second
   time under cuDNN, and in f32 (TF32 off) through cuDNN, the kernel and the
   plain nine-product conv, with the gaps between their last losses.

9. bench: ``cli.main(["bench", ...])`` at full width in its three modes:
   train at its default B = 8, infer at B = 32 (P bucketed to 128 for both)
   and e2e fed from the in-memory pipeline, cut to 16 pages and one timed
   epoch; each mode's JSON result and the kernels it launched (K1, K3, K5
   and K6 for train and e2e; K1 and K5, not K3 or K6, for infer; no conv
   kernel). Then the infer bench's batch is served with the kernels and
   with the plain ops (logits within two bf16 steps of the largest, the
   same picks), and one train-bench step's gradients are held against the
   plain pairs' at the train phase's tolerance.
10. export: ``cli export`` of the train phase's fold: the ``.pth``
   strict-loads into a fresh model and holds the checkpoint's tensors (f32
   floats, int64 counts); ``predict --torch_model`` on it picks the boxes
   ``predict`` from the checkpoint picks.
11. visualize: ``cli visualize --no_render`` on that fold: one attention
   CSV per test page (finite, attention weights a softmax), through K1 and
   K5.
12. sweep: ``cli sweep --folds 1 2 --synthetic_hard`` on 10 pages at full
   width, one epoch a fold: finite losses, both folds' rows of
   ``oracle_acc.csv`` and ``sweep_summary.txt``, through K1, K3, K5, K6.
13. parallel: the port on two ranks, two processes on this card over gloo
   launched through ``COVA_COORDINATOR_ADDRESS`` / ``COVA_NUM_PROCESSES``
   / ``COVA_PROCESS_ID``, at full width: (a) ``cli train`` on 20 pages at
   global -bs 10 (5 a rank), one epoch, then ``cli eval``; each rank's
   launches of K1, K3, K5 and K6, counted from 0 over its run, must be
   non-zero; rank 0 alone prints the epochs and writes the artifacts; a
   one-process ``eval`` of the checkpoint gives the TEST rows of both
   two-rank runs. (b) One step of a fixed global batch (B = 10, P = 232,
   -dp 0, seeded weights) at dp = 2 and at dp = 1 x tp = 2
   (``cova_tpu_torch.parallel.step_check``), in bf16 and f32 (TF32 off),
   against the single-process step: the loss sums (rtol 1e-3 in bf16,
   1e-5 in f32) and every gradient within the train phase's rule (dp = 2:
   or within 1.5 times the distance of the single step with the batch's
   halves swapped, see PAR_SPREAD_MARGIN); each run's ms per global step (host clock, mean of 5 after 2
   warm-ups) beside the single-process step's, and the gradient
   collectives' ms and bytes. (c) With two or more cards, (b) over NCCL,
   one card a rank; otherwise ``"nccl": "one card: not run"``.

The train phase also feeds batches through the device prefetcher and holds
them against the host batches byte for byte. Every phase line carries its
seconds.

(Phases run in the order 1-3, 6, 4, 5, 9-13, 7, 8.) Then it prints the
kernels' summary line (one row per TPU kernel, K1-K8), the ``nvidia-smi``
line, and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero; without a GPU,
or outside the repo, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, dense
TF32_OPS_PER_S = 494.7e12  # H100 SXM TF32 on the tensor cores, dense
SEED = 123
B, IMG, P, CTX = 10, 1280, 232, 12
N_PAGES, MAX_PAGES = 100, 20  # predict serves the 20-page test split
TRAIN_B, TRAIN_PAGES = 5, 40  # the flagship train batch; a 24/8/8 split
# The benches at their own batches: train at its default B = 8, infer at
# B = 32; e2e cut to 16 pages and one timed epoch (its defaults are 64
# pages and three epochs) to keep the phase short.
BENCH_TRAIN_B, BENCH_INFER_B = 8, 32
E2E_PAGES, E2E_EPOCHS = 16, 1
SWEEP_PAGES = 10  # per fold a 6/2/2 split
# The parallel phase: two ranks of the flagship's 5 pages (global -bs 10)
# on 20 pages (a 12/4/4 split); steps timed as the mean of 5 after 2
# warm-ups; every launch of ranks under a time limit.
PAR_PAGES, PAR_B = 20, 10
PAR_DEVICE = "cuda:0"  # both ranks on one card: gloo
PAR_TIMING = {"warmup": 2, "reps": 5}
PAR_TIMEOUT = 300
TRAIN_KERNELS = ("roi_pool_fwd", "roi_pool_bwd", "bn_relu_pool_fwd",
                 "bn_relu_pool_bwd")
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


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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


# Timings of the redesigned K1 and K6, one after another in one call.
TIMING_RUNS = 10


def timings(torch, fn, reps: int, warmup: int = 3):
    """TIMING_RUNS timings of ``reps`` launches each (CUDA events, ms per
    launch): their median, all of them in the order taken, and their spread
    (max - min)."""
    ms = [cuda_ms(torch, fn, reps=reps, warmup=warmup if k == 0 else 1)
          for k in range(TIMING_RUNS)]
    return dict(ms=sorted(ms)[len(ms) // 2], ms_runs=ms,
                ms_spread=max(ms) - min(ms))


def roi_bins_px(torch, boxes, mask, h, w, out_h=3, out_w=3):
    """Pixel counts of every bin, [B, P, out_h, out_w], and the pixels the
    forward kernel reads for them: each bin's edge rows and pyramid chunks
    (``ops/roi_pool.py:bin_rows``) times its width."""
    from cova_tpu_torch.ops.roi_pool import bin_rows, roi_bounds

    bd = roi_bounds(boxes, mask, 0.25, out_h, out_w, h, w).long()
    ylo, yhi, xlo, xhi = bd.split([out_h, out_h, out_w, out_w], -1)
    rows = torch.tensor([
        sum(e - s for s, e in bin_rows(lo, hi, h)) if hi > lo else 0
        for lo, hi in zip(ylo.flatten().tolist(), yhi.flatten().tolist())
    ], device=bd.device).view_as(ylo)
    width = (xhi - xlo).clamp(min=0)[..., None, :]
    return (yhi - ylo).clamp(min=0)[..., :, None] * width, int(
        (rows[..., :, None] * width).sum())


# RoIPool forward (K1) checks away from the flagship shape: (B, H, W, C, P,
# out_h, out_w). H and W that are no multiple of the pyramid's 8-row chunk,
# or exactly one chunk; C of 6 and 130, where the kernel reads pairs of
# channels instead of 16 bytes; out_h != out_w, one bin and 32 bins. Every
# case's boxes include a whole-map box, boxes whose bins start and end on
# chunk boundaries, boxes with bins of one row, and boxes beyond the image;
# its last image has every box masked.
ROI_RAGGED = ((2, 37, 29, 64, 40, 3, 3), (2, 13, 50, 6, 20, 2, 4),
              (2, 9, 17, 130, 16, 1, 1), (2, 8, 8, 64, 12, 4, 8),
              (3, 24, 40, 16, 30, 3, 3), (2, 1, 12, 64, 8, 3, 3))
# Fused BN+ReLU+pool backward (K6) checks: (B, U, V, O). U and V of 1, and
# one below and one above the kernel's tiles (8 x 16 in bf16, 8 x 8 in
# f32); O of 2 and 6, where the kernel copies pairs of channels, and 64 and
# 512, where it splits the channels into chunks.
BN_RAGGED = ((1, 1, 1, 2), (2, 7, 9, 64), (1, 9, 7, 6), (2, 9, 1, 64),
             (1, 1, 9, 512), (1, 17, 15, 64), (2, 7, 7, 512),
             (1, 9, 17, 64), (2, 7, 15, 6), (1, 1, 33, 64))
# Fused BN+ReLU+pool forward (K5) checks: (B, U, V, O). U and V of 1, one
# below and one above the kernel's 8 x 16 tile, and more than one tile;
# O of 2 and 6, where the kernel copies pairs of channels by cp.async, 8
# (one chunk) and 512 (many). Each is run from a 16-byte aligned ys and
# from one 8 bytes past it (pairs of channels, by cp.async).
BN_FWD_RAGGED = ((1, 1, 1, 2), (2, 7, 15, 64), (1, 9, 17, 6), (2, 17, 33, 8),
                 (1, 1, 16, 64), (1, 8, 1, 512), (2, 9, 31, 512))


def ragged_boxes(torch, gen, b, p, h, w, dev):
    """Random boxes in image coordinates (4x the map), some reaching past
    it, with the special boxes of ROI_RAGGED's note first."""
    img_h, img_w = 4 * h, 4 * w
    x1 = torch.rand(b, p, generator=gen, device=dev) * (img_w + 8) - 8
    y1 = torch.rand(b, p, generator=gen, device=dev) * (img_h + 8) - 8
    x2 = x1 + torch.rand(b, p, generator=gen, device=dev) * (img_w + 8 - x1)
    y2 = y1 + torch.rand(b, p, generator=gen, device=dev) * (img_h + 8 - y1)
    boxes = torch.stack([x1, y1, x2, y2], -1)
    special = [(0, 0, img_w, img_h),  # the whole map
               (0, 32, img_w - 1, 4 * 24 - 1),  # rows 8 .. 23: chunk edges
               (4, 4 * 16, 4 * 9, 4 * 17 - 1),  # one chunk, rows 16 .. 16
               (8, 2, 40, 12)]  # bins of one row
    for k, box in enumerate(special[:p]):
        boxes[:, k] = torch.tensor(box, dtype=torch.float32, device=dev)
    mask = torch.rand(b, p, generator=gen, device=dev) < 0.8
    mask[:, 0] = True
    mask[-1] = False  # one page that is all padding
    return boxes, mask


def _template_args(s: str):
    """The template arguments at the start of an Itanium-mangled list
    (after its ``I``): types as f32 / bf16, literals as their values."""
    import re

    args, k = [], 0
    while k < len(s) and s[k] != "E":
        if s[k] == "L":  # a literal: L <type> <value> E
            end = s.index("E", k)
            kind, val = s[k + 1], s[k + 2 : end]
            args.append({"b": {"1": "true", "0": "false"}.get(val, val)}.get(
                kind, val))
            k = end + 1
        elif s[k].isdigit():  # a named type: <length> <name>
            n = re.match(r"\d+", s[k:]).group()
            name = s[k + len(n) : k + len(n) + int(n)]
            args.append("bf16" if "bfloat16" in name else name)
            k += len(n) + int(n)
        elif s[k] == "f":
            args.append("f32")
            k += 1
        else:
            break
    return args


def ptxas_report(log: str, kernels):
    """Registers and spill bytes of the named kernels from ptxas -v, keyed
    by name and template arguments (e.g. ``bn_relu_pool_fwd_kernel<bf16,8,
    true>``)."""
    import re

    rows, name = {}, None
    alt = "|".join(kernels)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(" + alt + r")I(\w+)",
                      line)
        if m:
            name = f"{m.group(1)}<{','.join(_template_args(m.group(2)))}>"
            rows[name] = {}
        elif name and "spill stores" in line:
            n = re.findall(r"(\d+) bytes", line)
            rows[name].update(stack=int(n[0]), spill_stores=int(n[1]),
                              spill_loads=int(n[2]))
        elif name and "Used" in line and "registers" in line:
            rows[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                    line).group(1))
            name = None
    return rows


def sass_report(build, kernels):
    """What ``cuobjdump -sass`` shows of the named kernels in the built
    libraries ({library: kernel name}): per instantiation, its instruction
    count, its CALL instructions (nvcc calls a subroutine for a 64-bit
    division or remainder) and the 64-bit integer division or remainder
    routines it names. None where the toolkit has no cuobjdump."""
    import re

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    rows = {}
    for lib, kernel in kernels.items():
        dump = subprocess.run([tool, "-sass", build._lib_path(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        for part in dump.split("Function : ")[1:]:
            mangled = part.split()[0]
            m = re.search(kernel + r"I(\w+)", mangled)
            if not m:
                continue
            body = [ln for ln in part.splitlines()
                    if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
            rows[f"{kernel}<{','.join(_template_args(m.group(1)))}>"] = dict(
                instructions=len(body),
                calls=sum(" CALL" in ln for ln in body),
                div64_routines=sorted({r for ln in body for r in re.findall(
                    r"__\w*(?:div|rem)\w*64\w*", ln)}))
    return rows


def phase_kernels(torch, dev):
    from cova_tpu_torch.ops.bn_pool import (
        bn_relu_pool_s2d,
        bn_relu_pool_s2d_backward,
        bn_relu_pool_s2d_backward_reference,
        bn_relu_pool_s2d_reference,
        bwd_plan,
        fwd_plan,
    )
    from cova_tpu_torch.ops.roi_pool import (
        roi_bounds,
        roi_bwd_plan,
        roi_bwd_tile_pairs,
        roi_pool,
        roi_pool_backward,
        roi_pool_backward_reference,
        roi_pool_bounds,
        roi_pool_plan,
        roi_pool_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    checks = {}

    def check_bounds(boxes, mask, oh, ow, h, w, tag):
        """The bounds kernel (K3's first launch) equals roi_bounds."""
        args = (boxes, mask, 0.25, oh, ow, h, w)
        need(torch.equal(roi_pool_bounds(*args), roi_bounds(*args)),
             f"{tag}: the bounds kernel differs from roi_bounds")
        return args

    # K1 away from the flagship shape, bit-exact.
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, w, c, p, oh, ow in ROI_RAGGED:
            fm = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
            boxes, mask = ragged_boxes(torch, gen, b, p, h, w, dev)
            args = (fm, boxes, mask, 0.25, oh, ow)
            tag = f"roi_pool_fwd_{b}x{h}x{w}x{c}_P{p}_{oh}x{ow}_{dtype}"
            check_bounds(boxes, mask, oh, ow, h, w, tag)
            got, want = roi_pool(*args), roi_pool_reference(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            need(err == 0.0, f"{tag} differs from its plain version by {err}")
            need(not got[~mask].any(), f"{tag}: a masked box is not zero")
            checks[tag] = dict(max_abs_err=err, vec=roi_pool_plan(
                dtype, b, p, h, w, c, oh, ow).vec)

    boxes, mask = synthetic_boxes(torch, dev)
    h = w = IMG // 4
    b, p = mask.shape
    covered, bin_px = roi_work(torch, boxes, mask, h, w)
    bins_px, pyramid_reads = roi_bins_px(torch, boxes, mask, h, w)
    largest_bin = int(bins_px.max())
    # The bin bounds by their kernel (K3's first launch) and by the plain
    # chain of PyTorch ops that it replaces on the card.
    bd_args = check_bounds(boxes, mask, 3, 3, h, w, "roi_pool_bounds")
    bounds_times = dict(
        bounds_ms=cuda_ms(torch, lambda: roi_pool_bounds(*bd_args), reps=20,
                          warmup=3),
        bounds_plain_ms=cuda_ms(torch, lambda: roi_bounds(*bd_args), reps=20,
                                warmup=3))
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
        t = timings(torch, lambda: roi_pool(*args), reps=20)
        plan = roi_pool_plan(dtype, b, p, h, w, 64, 3, 3)
        results[name] = dict(
            max_abs_err=err, **t,
            plain_ms=cuda_ms(torch, lambda: roi_pool_reference(*args),
                             reps=2),
            bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
            achieved_gb_per_s=n_bytes / t["ms"] / 1e6,
            bound_share=bms / t["ms"],
            reread_factor=bin_px / covered, largest_bin_px=largest_bin,
            covered_px=covered, bin_px=bin_px,
            pyramid_reads_px=pyramid_reads,
            pyramid_bytes=fm.numel() // h * plan.n_chunks * isz,
            **bounds_times, valid_boxes=int(mask.sum()), shape=list(fm.shape), P=P,
            dtype=str(dtype),
        )
        del fm, got, want

    # K5 away from the flagship shape, bit-exact, then at it (bf16 and f32).
    def check_fwd(ys, scale, shift, tag):
        got = bn_relu_pool_s2d(ys, scale, shift)
        want = bn_relu_pool_s2d_reference(ys, scale, shift)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max()) if \
            got.numel() else 0.0
        need(err == 0.0, f"{tag} differs from its plain version by {err}")
        return err

    for dtype in (torch.bfloat16, torch.float32):
        for b_, u, v, o in BN_FWD_RAGGED:
            scale = torch.rand(o, generator=gen, device=dev) + 0.5
            shift = torch.randn(o, generator=gen, device=dev) * 0.5
            for offset in (0, 8 // torch.empty((), dtype=dtype).element_size()):
                n = b_ * u * v * 4 * o
                flat = tied(torch, gen, (n + offset,), dtype, dev, 8.0)
                ys = flat[offset:].view(b_, u, v, 4 * o)  # 8 mod 16 bytes
                tag = (f"bn_relu_pool_fwd_{b_}x{u}x{v}x{o}_{dtype}"
                       + ("_unaligned" if offset else ""))
                checks[tag] = dict(
                    max_abs_err=check_fwd(ys, scale, shift, tag),
                    plan=fwd_plan(dtype, b_, u, v, o,
                                  aligned=ys.data_ptr() % 16 == 0)._asdict())
    scale = torch.rand(64, generator=gen, device=dev) + 0.5
    shift = torch.randn(64, generator=gen, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        ys = torch.randn(B, h, w, 256, generator=gen, device=dev).to(dtype)
        name = "bn_relu_pool_fwd" + ("" if dtype == torch.bfloat16 else "_f32")
        err = check_fwd(ys, scale, shift, name)
        isz = ys.element_size()
        n_out = B * h * w * 64
        n_bytes = ys.numel() * isz + 2 * 64 * 4 + n_out * isz
        n_ops = n_out * (9 * 3 + 1)  # nine affines and maxima, one ReLU
        bms, by = bound_ms(n_bytes, n_ops)
        t = timings(torch, lambda: bn_relu_pool_s2d(ys, scale, shift),
                    reps=20)
        results[name] = dict(
            max_abs_err=err, **t,
            plain_ms=cuda_ms(
                torch, lambda: bn_relu_pool_s2d_reference(ys, scale, shift),
                reps=3),
            bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
            achieved_gb_per_s=n_bytes / t["ms"] / 1e6,
            bound_share=bms / t["ms"],
            plan=fwd_plan(dtype, B, h, w, 64)._asdict(),
            shape=list(ys.shape), dtype=str(dtype),
        )
        del ys

    # K3 away from the flagship shape, bit-exact on tied inputs; the first
    # shape again with a pair list of 8 and a stage chunk of 3 pairs, so its
    # tiles walk their pairs in several lists and chunks.
    for dtype in (torch.bfloat16, torch.float32):
        for k, (b_, h_, w_, c, p_, oh, ow) in enumerate(ROI_RAGGED):
            fm = tied(torch, gen, (b_, h_, w_, c), dtype, dev, 2.0)
            boxes_r, mask_r = ragged_boxes(torch, gen, b_, p_, h_, w_, dev)
            pooled = roi_pool_reference(fm, boxes_r, mask_r, 0.25, oh, ow)
            g = torch.randn(pooled.shape, generator=gen, device=dev).to(dtype)
            args = (fm, boxes_r, mask_r, pooled, g, 0.25, oh, ow)
            want = roi_pool_backward_reference(*args)
            plans = [None]
            if k == 0:
                plans.append(roi_bwd_plan(dtype, b_, p_, h_, w_, c, oh, ow,
                                          cap=8, round_=4, chunk=3))
            for plan in plans:
                tag = (f"roi_pool_bwd_{b_}x{h_}x{w_}x{c}_P{p_}_{oh}x{ow}_"
                       f"{dtype}" + ("_cap8" if plan else ""))
                got = roi_pool_backward(*args, plan=plan)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                need(err == 0.0, f"{tag} differs from its plain version by "
                                 f"{err}")
                checks[tag] = dict(max_abs_err=err, plan=(plan or roi_bwd_plan(
                    dtype, b_, p_, h_, w_, c, oh, ow))._asdict())

    # The backward kernels at the train batch, on tied inputs.
    boxes, mask = synthetic_boxes(torch, dev, TRAIN_B)
    b, p = mask.shape
    covered, bin_px = roi_work(torch, boxes, mask, h, w)
    pairs = roi_bwd_tile_pairs(roi_bounds(boxes, mask, 0.25, 3, 3, h, w), h,
                               w, 3, 3).float()
    tile_pairs = dict(tile=list(roi_bwd_plan(torch.bfloat16, b, p, h, w, 64,
                                             3, 3).tile),
                      n_tiles=pairs.numel(), mean=float(pairs.mean()),
                      largest=int(pairs.max()),
                      empty_share=float((pairs == 0).float().mean()),
                      total=int(pairs.sum()))
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
        t = timings(torch, lambda: roi_pool_backward(*args), reps=20)
        results[name] = dict(
            max_abs_err=err, **t,
            plain_ms=cuda_ms(torch, lambda: roi_pool_backward_reference(
                *args), reps=1),
            bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
            achieved_gb_per_s=n_bytes / t["ms"] / 1e6,
            bound_share=bms / t["ms"], tile_pairs=tile_pairs,
            plan=roi_bwd_plan(dtype, b, p, h, w, 64, 3, 3)._asdict(),
            valid_boxes=int(mask.sum()), shape=list(fm.shape), P=P,
            dtype=str(dtype), tied_dfm_share=float(
                (want.float().abs() > 0).float().mean()),
        )
        del fm, pooled, g, got, want, args

    # K6 away from the flagship shape, then at it (bf16 and f32), on tied
    # inputs: dys bit-exact; d(scale)/d(shift), f32 sums over the whole map
    # in another order, within rtol 1e-4 plus 1e-4 of their largest value.
    def check_bwd(shape, dtype, tag):
        b_, u, v, o = shape
        ys = tied(torch, gen, (b_, u, v, 4 * o), dtype, dev, 8.0)
        scale = torch.rand(o, generator=gen, device=dev) + 0.5
        shift = torch.randn(o, generator=gen, device=dev) * 0.5
        g = torch.randn(b_, u, v, o, generator=gen, device=dev).to(dtype)
        bargs = (ys, scale, shift, g)
        got = bn_relu_pool_s2d_backward(*bargs)
        want = bn_relu_pool_s2d_backward_reference(*bargs)
        torch.cuda.synchronize()
        err = float((got[0].float() - want[0].float()).abs().max())
        need(err == 0.0, f"{tag} dys differs from its plain version by {err}")
        sum_err = []
        for a, ref in zip(got[1:], want[1:]):
            d = float((a - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            need(bool(((a - ref).abs() <= tol + 1e-4 * ref.abs()).all()),
                 f"{tag} d(scale)/d(shift) differ by {d}")
            sum_err.append(d)
        return bargs, dict(max_abs_err=err, dscale_dshift_max_abs_err=sum_err)

    for dtype in (torch.bfloat16, torch.float32):
        for shape in BN_RAGGED:
            tag = "bn_relu_pool_bwd_" + "x".join(map(str, shape)) + f"_{dtype}"
            _, checks[tag] = check_bwd(shape, dtype, tag)
            checks[tag]["plan"] = bwd_plan(dtype, *shape)._asdict()
    for dtype in (torch.bfloat16, torch.float32):
        shape = (TRAIN_B, h, w, 64)
        name = "bn_relu_pool_bwd" + ("" if dtype == torch.bfloat16 else "_f32")
        bargs, row = check_bwd(shape, dtype, name)
        ys, g = bargs[0], bargs[3]
        isz = ys.element_size()
        n_bytes = 2 * ys.numel() * isz + g.numel() * isz + 2 * 64 * 4 * 2
        n_ops = ys.numel() * 8  # affine 2, tie-rule compares 3, sums 3
        bms, by = bound_ms(n_bytes, n_ops)
        t = timings(torch, lambda: bn_relu_pool_s2d_backward(*bargs), reps=20)
        results[name] = dict(
            row, **t,
            plain_ms=cuda_ms(
                torch, lambda: bn_relu_pool_s2d_backward_reference(*bargs),
                reps=3),
            bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
            achieved_gb_per_s=n_bytes / t["ms"] / 1e6,
            bound_share=bms / t["ms"],
            plan=bwd_plan(dtype, *shape)._asdict(),
            shape=list(ys.shape), dtype=str(dtype),
        )
        del bargs, ys, g
    return results, checks


# Shapes of the conv kernels' checks: (B, H, W, C, O). The small ones have
# H != W, neither a multiple of a tile side, and more than one row segment
# of the output-stationary kernel; the flagship ones are the model's convs at
# the serving batch (layer1's four, and the s2d stem's).
CONV_SMALL = ((2, 13, 37, 48, 256), (2, 13, 37, 256, 48), (2, 13, 37, 64, 64))
# Shapes that cross the bf16 kernels' tile edges: K7's 8 x 8 sub-tiles and
# 16 x 16 tiles, K8's strips of 2 rows and tiles of 64 columns (a row that
# ends with a tile, one pixel short of it and one past it); B = 3; and C of
# 128 and 512, where the weights stream through the ring.
CONV_RAGGED = ((3, 11, 7, 32, 64), (1, 17, 63, 64, 64), (2, 3, 64, 16, 32),
               (1, 33, 65, 48, 64), (1, 18, 129, 64, 16),
               (1, 40, 31, 128, 128), (3, 20, 24, 512, 512))
CONV_LAYER1 = (B, IMG // 4, IMG // 4, 64, 64)
CONV_STEM = (B, IMG // 4, IMG // 4, 48, 256)
# Largest |kernel - plain| over the largest |plain|: bf16 rounds the f32 sum
# once (half a step, 2^-9 relative) and the sums are taken in another order,
# so a sum next to a rounding boundary may land one step (2^-8) away; 2^-7
# leaves a factor of two. f32: only the order of the sum differs.
CONV_TOL = {"torch.bfloat16": 2.0 ** -7, "torch.float32": 1e-5}
# ms of the wmma kernels (no ring, weights re-read per tile) that the bf16
# kernels replaced, and of the FMA kernels (CUDA cores, one block per tile)
# that the split-TF32 f32 kernels replaced, on an NVIDIA H100 80GB HBM3 at
# 700 W, by this script.
CONV_WMMA_MS = {"conv3x3_fwd": 1.0127, "conv3x3_fwd_stem": 3.0614,
                "conv3x3_roll_fwd": 1.5580, "conv3x3_roll_fwd_stem": 4.633}
CONV_FMA_MS = {"conv3x3_fwd_f32": 3.7017, "conv3x3_fwd_stem_f32": 10.5970,
               "conv3x3_roll_fwd_f32": 4.0154,
               "conv3x3_roll_fwd_stem_f32": 12.8414}


def conv_operands(torch, gen, shape, dtype, dev):
    b, h, w, c, o = shape
    x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    k = (torch.randn(3, 3, c, o, generator=gen, device=dev)
         * (2.0 / (9 * c)) ** 0.5)
    return x, k


def conv_compare(torch, got, want, what):
    """Max abs error of ``got`` against the plain ``want``, held to
    CONV_TOL of the largest plain value; also the share of elements that are
    not bit-equal."""
    need(got.shape == want.shape and got.dtype == want.dtype,
         f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
         f"{want.dtype}")
    top = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    need(err <= CONV_TOL[str(want.dtype)] * top,
         f"{what} differs from its plain version by {err} (largest value "
         f"{top})")
    return dict(max_abs_err=err, largest=top,
                not_bit_equal=float((got != want).float().mean()))


def float64_error(got, exact):
    """Max and rms of ``got - exact`` over the largest |exact|."""
    d = got.double() - exact
    top = float(exact.abs().max())
    return dict(max=float(d.abs().max()) / top,
                rms=float(d.pow(2).mean().sqrt()) / top)


def conv_float64(torch, x, w):
    """The 3x3 conv taken in float64 (cuDNN) and rounded once to x.dtype,
    with ``conv3x3``'s gradient rule: the exact side of any near-tie."""
    import torch.nn.functional as F

    from cova_tpu_torch.ops.conv3x3 import _Conv3x3

    def fwd(a, b):
        y = F.conv2d(a.double().permute(0, 3, 1, 2),
                     b.double().permute(3, 2, 0, 1), padding=1)
        return y.permute(0, 2, 3, 1).to(a.dtype).contiguous()

    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3.apply(x, w, fwd)
    return fwd(x, w)


def conv_bound(shape, itemsize, dtype_name):
    """The least time for the conv: bytes over the memory rate or operations
    over the peak rate, the larger. f32 has two routes to f32 accuracy, FMAs
    on the CUDA cores or three TF32 passes on the tensor cores (split TF32);
    its bound is the lesser of the two, and ``bound_by`` names the route."""
    b, h, w, c, o = shape
    n_bytes = (b * h * w * (c + o) + 9 * c * o) * itemsize
    n_ops = 2 * 9 * c * o * b * h * w
    if dtype_name == "torch.bfloat16":
        ms, by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        return dict(bound_ms=ms, bound_by=by, bytes=n_bytes, operations=n_ops)
    routes = {"fma": bound_ms(n_bytes, n_ops, F32_OPS_PER_S),
              "split_tf32": bound_ms(n_bytes, 3 * n_ops, TF32_OPS_PER_S)}
    route = min(routes, key=lambda r: routes[r][0])
    ms, by = routes[route]
    return dict(bound_ms=ms, bound_by=by, bound_route=route,
                bound_ms_by_route={r: v[0] for r, v in routes.items()},
                bytes=n_bytes, operations=n_ops)


def phase_conv_kernels(torch, dev):
    """K7 (``conv3x3``) and K8 (``conv3x3_roll``) against the plain version:
    values at small ragged shapes and at the flagship shapes, K7's dx and dW
    against the plain (forward, backward) pair, and times beside the plain
    version's, ``F.conv2d``'s (cuDNN, TF32 off) and the bound."""
    import torch.nn.functional as F

    from cova_tpu_torch.ops.conv3x3 import (
        conv3x3,
        conv3x3_plain,
        conv3x3_reference,
        conv3x3_roll,
    )

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    checks = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in CONV_SMALL + CONV_RAGGED:
            x, k = conv_operands(torch, gen, shape, dtype, dev)
            want = conv3x3_reference(x, k)
            tag = f"{shape[3]}to{shape[4]}_{shape[1]}x{shape[2]}_{dtype}"
            for name, fn in (("conv3x3_fwd", conv3x3),
                             ("conv3x3_roll_fwd", conv3x3_roll)):
                got = fn(x, k)
                torch.cuda.synchronize()
                checks[f"{name}_{tag}"] = conv_compare(
                    torch, got, want, f"{name} {tag}")
            # dx through the kernel on the flipped weights, dW through the
            # library conv, against the plain pair.
            g = torch.randn(want.shape, generator=gen, device=dev).to(dtype)
            grads = []
            for fn in (conv3x3, conv3x3_plain):
                xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
                grads.append(torch.autograd.grad(fn(xg, kg), (xg, kg), g))
            torch.cuda.synchronize()
            checks[f"conv3x3_dx_{tag}"] = conv_compare(
                torch, grads[0][0], grads[1][0], f"conv3x3 dx {tag}")
            dw_err = float((grads[0][1] - grads[1][1]).abs().max())
            need(dw_err <= 2e-2 * float(grads[1][1].abs().max()),
                 f"conv3x3 dW {tag} differs by {dw_err}")

    results = {}
    for label, shape in (("layer1", CONV_LAYER1), ("stem", CONV_STEM)):
        for dtype in (torch.bfloat16, torch.float32):
            x, k = conv_operands(torch, gen, shape, dtype, dev)
            want = conv3x3_reference(x, k)
            kd = k.to(dtype)
            k_oihw = kd.permute(3, 2, 0, 1).contiguous()
            x_nchw = x.permute(0, 3, 1, 2)  # a channels-last view
            lib = F.conv2d(x_nchw, k_oihw, padding=1).permute(0, 2, 3, 1)
            row = dict(shape=list(shape), dtype=str(dtype),
                       **conv_bound(shape, x.element_size(), str(dtype)))
            row["library_vs_plain"] = float(
                (lib.float() - want.float()).abs().max())
            if dtype == torch.float32:
                # Error against a float64 conv, relative to its largest
                # output: max and rms, for the plain version and cuDNN
                # here, for each kernel below.
                exact = F.conv2d(x_nchw.double(), k_oihw.double(),
                                 padding=1).permute(0, 2, 3, 1)
                row["vs_float64"] = {
                    "plain": float64_error(want, exact),
                    "library": float64_error(lib, exact)}
            row["plain_ms"] = cuda_ms(
                torch, lambda: conv3x3_reference(x, k), reps=2)
            row["library_ms"] = cuda_ms(
                torch, lambda: F.conv2d(x_nchw, k_oihw, padding=1), reps=10,
                warmup=3)
            for name, fn in (("conv3x3_fwd", conv3x3),
                             ("conv3x3_roll_fwd", conv3x3_roll)):
                got = fn(x, k)
                torch.cuda.synchronize()
                cmp_ = conv_compare(torch, got, want,
                                    f"{name} {label} {dtype}")
                t = timings(torch, lambda: fn(x, kd), reps=10)
                key = name + ("" if label == "layer1" else "_stem") + (
                    "_f32" if dtype == torch.float32 else "")
                results[key] = dict(
                    row, **t, tflops=row["operations"] / t["ms"] / 1e9,
                    bound_share=row["bound_ms"] / t["ms"], **cmp_)
                if dtype == torch.float32:
                    results[key]["vs_float64"] = dict(
                        row["vs_float64"], kernel=float64_error(got, exact))
                if key in CONV_WMMA_MS:
                    results[key]["wmma_ms"] = CONV_WMMA_MS[key]
                if key in CONV_FMA_MS:
                    results[key]["fma_ms"] = CONV_FMA_MS[key]
                del got
            del x, k, want, lib, row
            exact = None
    # K7 as the backward uses it, at the train batch: dx of layer1's conv.
    shape = (TRAIN_B,) + CONV_LAYER1[1:]
    x, k = conv_operands(torch, gen, shape, torch.bfloat16, dev)
    g = torch.randn(shape[:3] + (shape[4],), generator=gen,
                    device=dev).to(torch.bfloat16)
    grads = []
    for fn in (conv3x3, conv3x3_plain):
        xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(xg, kg), (xg, kg), g))
    torch.cuda.synchronize()
    checks["conv3x3_dx_layer1_train_batch"] = conv_compare(
        torch, grads[0][0], grads[1][0], "conv3x3 dx layer1")
    return results, checks


def kernel_wrappers():
    """Every kernel wrapper that counts its launches, by kernel name."""
    from cova_tpu_torch.ops import bn_pool, conv3x3, roi_pool

    return {"roi_pool_fwd": roi_pool.roi_pool,
            "bn_relu_pool_fwd": bn_pool.bn_relu_pool_s2d,
            "roi_pool_bwd": roi_pool.roi_pool_backward,
            "bn_relu_pool_bwd": bn_pool.bn_relu_pool_s2d_backward,
            "conv3x3_fwd": conv3x3.conv3x3,
            "conv3x3_roll_fwd": conv3x3.conv3x3_roll}


def launch_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def zero_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


@contextlib.contextmanager
def plain_ops():
    """The model's kernel ops swapped for their plain (forward, backward)
    pairs, with the conv opt-in off; fails unless no kernel launched
    meanwhile, so a moved call site cannot make the plain run compare the
    kernels with themselves."""
    from cova_tpu_torch.models import cova as cova_mod
    from cova_tpu_torch.models import resnet as resnet_mod
    from cova_tpu_torch.ops.bn_pool import bn_relu_pool_s2d_plain
    from cova_tpu_torch.ops.roi_pool import roi_pool_plain

    before = launch_counts()
    with mock.patch.object(cova_mod, "roi_pool", roi_pool_plain), \
            mock.patch.object(resnet_mod, "bn_relu_pool_s2d",
                              bn_relu_pool_s2d_plain), \
            mock.patch.dict(os.environ, {"COVA_CUDA_CONV": "0"}):
        yield
    need(launch_counts() == before,
         f"a kernel launched during the plain run: {before} -> "
         f"{launch_counts()}")


@contextlib.contextmanager
def conv_opt_in(watch: bool = True):
    """``COVA_CUDA_CONV=1`` inside. With ``watch``, fails if ``F.conv2d``
    ran a 3x3 stride-1 conv meanwhile: with the opt-in set those belong to
    the hand-written kernel."""
    import torch.nn.functional as F

    real, seen = F.conv2d, []

    def conv2d(x, w, bias=None, stride=1, *args, **kw):
        if tuple(w.shape[2:]) == (3, 3) and stride in (1, (1, 1)):
            seen.append(tuple(w.shape))
        return real(x, w, bias, stride, *args, **kw)

    with mock.patch.dict(os.environ, {"COVA_CUDA_CONV": "1"}), \
            mock.patch.object(F, "conv2d", conv2d if watch else real):
        yield
    need(not seen, f"F.conv2d ran 3x3 stride-1 convs under the opt-in: "
                   f"{seen[:4]}")


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
                if k in ("roi_pool_fwd", "bn_relu_pool_fwd")}
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


def grad_element_share(a, b, rel=1e-3):
    """The share of all gradient elements of ``a`` farther from ``b`` than
    ``rel`` of their tensor's largest gradient (plus GRAD_ATOL of the
    model's largest)."""
    g = max(float(v.abs().max()) for v in b.values())
    off = total = 0
    for k in b:
        tol = rel * float(b[k].abs().max()) + GRAD_ATOL * g
        off += int(((a[k] - b[k]).abs() > tol).sum())
        total += b[k].numel()
    return off / total


def train_flags(tmp):
    """The CLI flags of the train phase's fold (full width, 40 pages)."""
    return ["--synthetic", str(TRAIN_PAGES), "--img_height", str(IMG),
            "--output_dir", os.path.join(tmp, "train_results")]


def trained_fold(tmp):
    """The train phase's flags and results dir; when that phase did not run
    (phases named alone), one epoch of the same fold is trained first."""
    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config

    flags = train_flags(tmp)
    res = os.path.join(tmp, "train_results", Config(img_height=IMG)
                       .params_key)
    if not os.path.isfile(os.path.join(res, "Fold-1 saved_model.pt",
                                       "best.pt")):
        need(cli.main(["train", *flags, "-e", "1"]) == 0, "train failed")
    return flags, res


def phase_train(torch, dev, tmp):
    import numpy as np

    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import create_train_state, train_step

    out = os.path.join(tmp, "train_results")
    common = train_flags(tmp)
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", *common, "-e", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(rc == 0, f"train returned {rc}")
    conv = {k: launches.pop(k) for k in ("conv3x3_fwd", "conv3x3_roll_fwd")}
    need(all(n > 0 for n in launches.values()),
         f"a kernel was not launched on the train path: {launches}")
    need(not any(conv.values()),
         f"a conv kernel launched with the opt-in off: {conv}")

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

    prefetch = check_prefetcher(torch, dev, cfg)

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
        prefetcher=prefetch,
    )


def run_bench_cli(torch, flags):
    """``cli bench`` with ``flags``: its one JSON line, parsed, and the
    launches of each kernel counted from 0 over the run."""
    import io

    from cova_tpu_torch import cli

    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--img_height", str(IMG), *flags])
    torch.cuda.synchronize()
    need(rc == 0, f"bench {flags} returned {rc}")
    lines = [x for x in buf.getvalue().splitlines() if x.strip()]
    need(len(lines) == 1, f"bench {flags} printed {lines}")
    return json.loads(lines[0]), launch_counts()


def phase_bench(torch, dev):
    """The three benches through ``cli bench`` at full width, with the
    kernels each must launch; then the infer bench's batch served with the
    kernels against the plain ops, and one train-bench step's gradients
    against the plain pairs'."""
    import numpy as np

    from cova_tpu_torch import benchmarks
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import forward_step

    fwd = ("roi_pool_fwd", "bn_relu_pool_fwd")
    bwd = ("roi_pool_bwd", "bn_relu_pool_bwd")
    runs = {}
    for mode, flags, launched in (
        ("train", [], fwd + bwd),
        ("infer", ["-bsb", str(BENCH_INFER_B)], fwd),
        ("e2e", ["--e2e_source", "mem", "--e2e_pages", str(E2E_PAGES),
                 "--e2e_epochs", str(E2E_EPOCHS)], fwd + bwd),
    ):
        result, launches = run_bench_cli(torch, ["--mode", mode, *flags])
        need(all(launches[k] > 0 for k in launched),
             f"bench {mode}: a kernel of its path did not launch: "
             f"{launches}")
        need(not any(n for k, n in launches.items() if k not in launched),
             f"bench {mode}: a kernel off its path launched: {launches}")
        need(result["value"] > 0 and result["device"] ==
             torch.cuda.get_device_name(0), f"bench {mode}: {result}")
        runs[mode] = dict(result=result, launches=launches)
    need(runs["train"]["result"]["batch_size"] == BENCH_TRAIN_B,
         f"train bench at B={runs['train']['result']['batch_size']}")

    # The infer bench's batch (B = 32, P bucketed to 128) served with the
    # kernels and with the plain ops, from one set of weights.
    cfg = benchmarks.bench_config(BENCH_INFER_B, IMG, "bfloat16", False)
    batch = benchmarks.bench_batch(cfg, benchmarks.INFER_SEED)
    need(batch.boxes.shape[:2] == (BENCH_INFER_B, 128),
         f"infer bench batch {batch.boxes.shape}")
    model = build_model(cfg, device=dev)
    logits = forward_step(model, batch).logits
    with plain_ops():
        plain = forward_step(model, batch).logits
    infer_vs_plain = compare_logits(torch, dev, batch, logits, plain,
                                    CONV_LOGIT_STEPS, "infer bench batch")
    del model, logits, plain

    # One train-bench step (B = 8, P 128): its gradients against the plain
    # pairs' from the same weights, at the train phase's tolerance.
    cfg = benchmarks.bench_config(BENCH_TRAIN_B, IMG, "bfloat16", False)
    batch = benchmarks.bench_batch(cfg, benchmarks.TRAIN_SEED)
    need(batch.boxes.shape[:2] == (BENCH_TRAIN_B, 128),
         f"train bench batch {batch.boxes.shape}")
    model = build_model(cfg, device=dev)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    loss_k, grads_k = step_grads(torch, model, sd, batch, SEED)
    with plain_ops():
        loss_p, grads_p = step_grads(torch, model, sd, batch, SEED)
    loss_diff = abs(loss_k - loss_p)
    need(np.isfinite(loss_k) and loss_diff <= 1e-5 * abs(loss_p),
         f"train bench step: kernel and plain losses {loss_k} vs {loss_p}")
    grads_vs_plain = grad_diff(grads_k, grads_p)
    need(grads_vs_plain["share_of_tolerance"] <= 1.0,
         f"train bench step: gradients beyond the tolerance: "
         f"{grads_vs_plain}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()
    return dict(
        runs=runs, e2e_cut=dict(pages=E2E_PAGES, epochs=E2E_EPOCHS,
                                defaults=dict(pages=64, epochs=3)),
        infer_batch_vs_plain=dict(batch=BENCH_INFER_B, P=128,
                                  **infer_vs_plain),
        train_step_vs_plain=dict(
            batch=BENCH_TRAIN_B, P=128, loss_kernel=loss_k,
            loss_plain=loss_p, loss_abs_diff=loss_diff,
            grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL, **grads_vs_plain),
    )


def read_csv_rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split(",") for line in f]


def phase_export(torch, dev, tmp):
    """``cli export`` of the trained fold: the ``.pth`` strict-loads into a
    fresh model, holds the checkpoint's tensors (floats in f32), and
    ``predict --torch_model`` on it picks what ``predict`` from the
    checkpoint picks."""
    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.utils.checkpoint import load_checkpoint

    flags, res = trained_fold(tmp)
    rc = cli.main(["export", *flags])
    pth = os.path.join(res, "Fold-1 saved_model.pth")
    need(rc == 0 and os.path.isfile(pth), f"export returned {rc}")
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    build_model(Config(img_height=IMG), device="cpu").load_state_dict(
        sd, strict=True)
    best = load_checkpoint(os.path.join(res, "Fold-1 saved_model.pt",
                                        "best.pt"))["model"]
    need(set(sd) == set(best), "export changed the key set")
    for k, v in sd.items():
        need(v.dtype == (torch.float32 if v.is_floating_point()
                         else torch.int64), f"{k} exported as {v.dtype}")
        need(torch.equal(v, best[k].to(v.dtype)), f"{k} differs")
    preds = {}
    for name, extra in (("checkpoint", []), ("exported", ["--torch_model",
                                                         pth])):
        out = os.path.join(tmp, f"export_preds_{name}")
        rc = cli.main(["predict", *flags, *extra, "--out_dir", out])
        need(rc == 0, f"predict from the {name} weights returned {rc}")
        preds[name] = read_csv_rows(os.path.join(out, "retrieval.csv"))
    a, b = preds["checkpoint"], preds["exported"]
    need(len(a) == len(b) > 1, f"retrieval.csv rows {len(a)} vs {len(b)}")
    need([r[:7] for r in a] == [r[:7] for r in b],
         "predict --torch_model on the export picks other boxes")
    score_diff = max(abs(float(x[7]) - float(y[7]))
                     for x, y in zip(a[1:], b[1:]))
    return dict(tensors=len(sd), picks=len(a) - 1,
                max_score_abs_diff=score_diff)


def phase_visualize(torch, dev, tmp):
    """``cli visualize --no_render`` on the trained fold: one attention CSV
    per test page, finite, through the forward kernels."""
    import numpy as np

    from cova_tpu_torch import cli

    flags, res = trained_fold(tmp)
    zero_counts()
    rc = cli.main(["visualize", *flags, "--no_render"])
    torch.cuda.synchronize()
    launches = {k: n for k, n in launch_counts().items()
                if k in ("roi_pool_fwd", "bn_relu_pool_fwd")}
    need(rc == 0, f"visualize returned {rc}")
    need(all(n > 0 for n in launches.values()),
         f"a kernel was not launched on the visualize path: {launches}")
    out = os.path.join(res, "Fold-1 attention visualization")
    csvs = sorted(f for f in os.listdir(out) if f.endswith(".csv"))
    n_test = TRAIN_PAGES - int(TRAIN_PAGES * 0.8)
    need(len(csvs) == n_test, f"{len(csvs)} attention CSVs for {n_test} "
                              "test pages")
    for f in csvs:
        rows = np.loadtxt(os.path.join(out, f), delimiter=",", ndmin=2)
        need(rows.shape == (3, 5 + 10 * CTX) and np.isfinite(rows).all(),
             f"{f}: rows {rows.shape}")
        attn = rows[:, -2 * CTX:]
        # A softmax over the context slots, each written as %.3f.
        need(bool((attn >= 0).all()) and float(attn.sum(1).max())
             <= 1.0 + 2 * CTX * 5e-4 + 1e-6,
             f"{f}: attention weights {attn.sum(1)}")
    return dict(launches=launches, csvs=len(csvs))


def phase_sweep(torch, dev, tmp):
    """``cli sweep --folds 1 2 --synthetic_hard`` at full width, one epoch
    a fold: both folds train through the kernels, and the summary and
    oracle band are written."""
    import numpy as np

    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config

    out = os.path.join(tmp, "sweep_results")
    zero_counts()
    rc = cli.main(["sweep", "--synthetic", str(SWEEP_PAGES), "--img_height",
                   str(IMG), "-e", "1", "--synthetic_hard",
                   "--output_dir", out, "--folds", "1", "2"])
    torch.cuda.synchronize()
    launches = launch_counts()
    need(rc == 0, f"sweep returned {rc}")
    need(all(launches[k] > 0 for k in ("roi_pool_fwd", "bn_relu_pool_fwd",
                                       "roi_pool_bwd", "bn_relu_pool_bwd")),
         f"a kernel was not launched on the sweep path: {launches}")
    res = os.path.join(out, Config(img_height=IMG).params_key)
    losses = {}
    for fold in (1, 2):
        with open(os.path.join(res, f"Fold-{fold} logs.txt")) as f:
            losses[fold] = [float(line.split("Loss:")[1].split()[0])
                            for line in f if line.startswith("Epoch:")]
        need(len(losses[fold]) == 1 and np.isfinite(losses[fold]).all(),
             f"fold {fold} epoch losses {losses[fold]}")
    oracle = np.loadtxt(os.path.join(res, "oracle_acc.csv"), delimiter=",",
                        skiprows=1, ndmin=2)
    need(oracle[:, 0].tolist() == [1, 2], f"oracle_acc.csv {oracle}")
    with open(os.path.join(res, "sweep_summary.txt")) as f:
        summary = f.read()
    need(summary.startswith("folds: [1, 2]") and "oracle visible:"
         in summary, f"sweep_summary.txt: {summary!r}")
    return dict(launches=launches, epoch_losses=losses,
                oracle_acc=oracle.tolist(), summary=summary)


def cli_rank(out: str, args) -> int:
    """One rank of the parallel phase's CLI runs (``python3 chip_smoke.py
    _cli_rank OUT ARGS...``, with the launch environment): every launch
    count set to 0, ``cli.main(ARGS)``, then its code and the counts
    written to OUT."""
    import torch

    from cova_tpu_torch import cli

    zero_counts()
    rc = cli.main(list(args))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({"rc": rc, "launches": launch_counts()}, f)
    return rc


def launch_ranks(cmds, tmp, name, cwd=ROOT):
    """Run ``cmds`` (one per rank) as one launch through the COVA_*
    environment, each rank's output into ``tmp/<name>.rank<r>.log``; a
    failing rank stops the others, and so does PAR_TIMEOUT. Returns each
    rank's output."""
    from cova_tpu_torch.parallel.launch import free_port, rank_env, wait_all

    port = free_port()
    procs, logs = [], []
    for r, cmd in enumerate(cmds):
        env = rank_env(r, len(cmds), port)
        env["COVA_DIST_INIT_TIMEOUT"] = str(PAR_TIMEOUT)
        logs.append(os.path.join(tmp, f"{name}.rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(cmd, env=env, cwd=cwd, stdout=log,
                                          stderr=subprocess.STDOUT))
    codes = wait_all(procs, PAR_TIMEOUT)
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    for r, (rc, out) in enumerate(zip(codes, outs)):
        need(rc == 0, f"{name}: rank {r} returned {rc}:\n{out[-4000:]}")
    return outs


def rank_command(out, args):
    """The command of one rank of ``cli_ranks``."""
    return [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "_cli_rank",
            out, *args]


def cli_ranks(torch, args, tmp, name, n=2, cwd=ROOT):
    """``cli.main(args)`` as ``n`` ranks on this card (gloo); returns each
    rank's output and its kernel launches, counted from 0 over the run."""
    cmds = [rank_command(os.path.join(tmp, f"{name}.rank{r}.json"), args)
            for r in range(n)]
    outs = launch_ranks(cmds, tmp, name, cwd)
    launches = []
    for r in range(n):
        with open(os.path.join(tmp, f"{name}.rank{r}.json")) as f:
            launches.append(json.load(f)["launches"])
    return outs, launches


# The parallel phase's step rules. Losses: rtol 1e-3 in bf16, 1e-5 in f32.
# Gradients: tp = 2 splits no batch (every rank sums the BN statistics of
# all 10 pages in the single step's order) and is held to the train
# phase's rule. dp = 2 sums them as two halves, so its forward differs from
# the single step's in the last bits, and a training loss has kinks: among
# ~10^7 ReLU inputs and pooled maxima some lie within a rounding of theirs,
# and a unit that changes sides moves gradient entries by percents (f32,
# TF32 off, with the plain ops on the CPU: 0.02 of the tolerance at 64^2,
# 0.25 at 256^2). The same kinks show in one process when the batch's two
# halves are swapped (a step with the same loss and gradients, summed in
# another order; at 1280^2 on an NVIDIA H100 80GB HBM3 at 700 W: 0.956
# of the tolerance in f32, 6.13 in bf16, where every activation after a
# BN is a bf16 step off, on the tensors where dp = 2 sits at 0.954 and
# 6.64): dp = 2 may be no farther from the single step than
# PAR_SPREAD_MARGIN times that, or the rule, whichever is larger.
PAR_LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-5}
PAR_SPREAD_MARGIN = 1.5


def parallel_steps(torch, root, device, layouts, singles, swapped, n=2):
    """One step of the saved global batch on each of ``layouts`` in each
    dtype of ``singles`` (one launch of ``n`` ranks of
    ``parallel.step_check`` on ``device``), held against the single-process
    steps ``singles`` ({dtype: run_layout's result}): the loss sum, every
    rank's kernels launched, and every gradient within the train phase's
    rule (dp > 1: or within PAR_SPREAD_MARGIN of ``swapped``'s distance,
    the single step with the batch's halves swapped)."""
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec.update(layouts=layouts, device=device, dtypes=list(singles))
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    launch_ranks([[sys.executable, "-m", "cova_tpu_torch.parallel.step_check",
                   root]] * n, root, f"step_{device.replace(':', '')}")
    rows = {}
    for dtype, single in singles.items():
        for n_data, n_model in layouts:
            tag = f"{n_data}x{n_model}.{dtype}"
            res = torch.load(os.path.join(root, f"{tag}.pt"),
                             weights_only=True)
            ranks = []
            for r in range(n):
                with open(os.path.join(root, f"{tag}.rank{r}.json")) as f:
                    ranks.append(json.load(f))
                need(all(ranks[r]["launches"][k] > 0
                         for k in TRAIN_KERNELS),
                     f"{tag} on {device}: rank {r} launched {ranks[r]}")
            loss_rel = abs(res["loss_sum"] - single["loss_sum"]) / abs(
                single["loss_sum"])
            need(loss_rel <= PAR_LOSS_RTOL[dtype],
                 f"{tag} on {device}: loss {res['loss_sum']} vs "
                 f"{single['loss_sum']}")
            vs_single = grad_diff(res["grads"], single["grads"])
            spread = swapped[dtype]["share_of_tolerance"]
            limit = (max(1.0, PAR_SPREAD_MARGIN * spread) if n_data > 1
                     else 1.0)
            need(vs_single["share_of_tolerance"] <= limit,
                 f"{tag} on {device}: gradients beyond the tolerance "
                 f"against the single-process step: {vs_single} (limit "
                 f"{limit})")
            rows[tag] = dict(
                layout={"data": n_data, "model": n_model},
                loss_sum=res["loss_sum"], loss_rel_diff=loss_rel,
                grad_vs_single=vs_single,
                grad_limit=limit,
                elements_beyond_1e_3=grad_element_share(res["grads"],
                                                        single["grads"]),
                ms_per_step=[x["ms_per_step"] for x in ranks],
                grad_sync_ms=[x["grad_sync_ms"] for x in ranks],
                allreduce_bytes=ranks[0]["allreduce_bytes"],
                broadcast_bytes=ranks[0]["broadcast_bytes"],
                launches=[x["launches"] for x in ranks])
    return rows


def phase_parallel(torch, dev, tmp):
    """The port on two ranks (two processes on this card over gloo,
    launched through the COVA_* environment) at full width: (a) ``cli
    train`` (-bs 10 global, one epoch) then ``cli eval`` on both ranks,
    every rank through K1, K3, K5 and K6, rank 0 alone printing and
    writing, and a one-process ``eval`` of the checkpoint giving the
    two-rank TEST rows; (b) one step of a fixed global batch (B = 10, P =
    232, -dp 0, seeded weights) at dp = 2 and at tp = 2 against the
    single-process step, timed; (c) (b) over NCCL, one card a rank, where
    the host has two cards."""
    import numpy as np

    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_pipelines
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.parallel.step_check import run_layout, save_batch

    out = os.path.join(tmp, "par_results")
    flags = ["--synthetic", str(PAR_PAGES), "--img_height", str(IMG), "-bs",
             str(PAR_B), "--device", PAR_DEVICE, "--output_dir", out]
    t0 = time.perf_counter()
    outs, launches = cli_ranks(torch, ["train", *flags, "-e", "1"], tmp,
                               "train")
    train_s = time.perf_counter() - t0
    for r, got in enumerate(launches):
        need(all(got[k] > 0 for k in TRAIN_KERNELS),
             f"train rank {r}: a kernel of the path did not launch: {got}")
    need("Epoch:" in outs[0] and "Epoch:" not in outs[1],
         "rank 0 alone prints the epochs")
    need("Mesh: {'data': 2, 'model': 1} backend: gloo" in outs[0],
         "rank 0 logs the mesh")
    res = os.path.join(out, Config(img_height=IMG, batch_size=PAR_B)
                       .params_key)
    for name in ("Fold-1 logs.txt", "Fold-1 test_acc_imgwise.csv",
                 "Fold-1 test_acc_domainwise.csv", "fold_wise_acc.csv",
                 "metrics.jsonl", "Fold-1 saved_model.pt/best.pt",
                 "Fold-1 saved_model.pt/last.pt"):
        need(os.path.isfile(os.path.join(res, name)),
             f"two-rank train wrote no {name!r}")
    with open(os.path.join(res, "Fold-1 logs.txt")) as f:
        log = f.read()
    need(log.count("Epoch:") == 1, "the log holds one epoch line")
    with open(os.path.join(res, "fold_wise_acc.csv")) as f:
        need(len(f.read().strip().splitlines()) == 2, "one fold row")

    ev2, ev1 = os.path.join(tmp, "eval2"), os.path.join(tmp, "eval1")
    os.makedirs(ev2)
    os.makedirs(ev1)
    t0 = time.perf_counter()
    _, eval_launches = cli_ranks(torch, ["eval", *flags], tmp, "eval",
                                 cwd=ev2)
    eval_s = time.perf_counter() - t0
    cwd = os.getcwd()
    os.chdir(ev1)
    try:
        need(cli.main(["eval", *flags]) == 0, "one-process eval failed")
    finally:
        os.chdir(cwd)
    csv = "Fold-1 test_acc_imgwise.csv"
    one = read_csv_rows(os.path.join(ev1, csv))
    need(read_csv_rows(os.path.join(ev2, csv)) == one,
         "the two-rank eval's TEST rows differ from one process's")
    need(read_csv_rows(os.path.join(res, csv)) == one,
         "the two-rank train's TEST rows differ from the one-process eval "
         "of its checkpoint")

    # (b) one step of one global batch, from one set of seeded weights.
    cfg = Config(img_height=IMG, batch_size=PAR_B, drop_prob=0.0)
    ds = InMemoryWebDataset(PAR_B, IMG, seed=SEED + 3,
                            max_boxes=cfg.max_boxes)
    train_p, _, _ = make_pipelines(cfg, ds, ds, ds)
    _, batch = next(iter(train_p.epoch(1)))
    batch = pad_batch(batch, PAR_B)[0]
    need(batch.boxes.shape[:2] == (PAR_B, P), f"batch {batch.boxes.shape}")
    sd = random_state_dict(torch, cfg)
    root = os.path.join(tmp, "step")
    os.makedirs(root)
    torch.save(sd, os.path.join(root, "weights.pt"))
    save_batch(os.path.join(root, "batch.npz"), batch)
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(dict(config=dict(img_height=IMG, batch_size=PAR_B,
                                   drop_prob=0.0), seed=SEED,
                       timing=PAR_TIMING), f)
    singles, swapped = {}, {}
    half = PAR_B // 2
    flipped = type(batch)(*[np.concatenate([x[half:], x[:half]])
                            for x in batch])
    for dtype in ("bfloat16", "float32"):
        dcfg = cfg.replace(compute_dtype=dtype)
        singles[dtype] = run_layout(dcfg, sd, batch, dev, SEED, None,
                                    PAR_TIMING)
        need(all(singles[dtype]["launches"][k] > 0 for k in TRAIN_KERNELS),
             f"single-process step launched {singles[dtype]['launches']}")
        other = run_layout(dcfg, sd, flipped, dev, SEED, None)
        swapped[dtype] = dict(
            **grad_diff(other["grads"], singles[dtype]["grads"]),
            loss_rel_diff=abs(other["loss_sum"] - singles[dtype]["loss_sum"])
            / abs(singles[dtype]["loss_sum"]),
            elements_beyond_1e_3=grad_element_share(
                other["grads"], singles[dtype]["grads"]))
        del other
    layouts = [[2, 1], [1, 2]]
    steps = parallel_steps(torch, root, PAR_DEVICE, layouts, singles,
                           swapped)
    if torch.cuda.device_count() >= 2:
        nccl = parallel_steps(torch, root, "cuda", layouts, singles, swapped)
    else:
        nccl = "one card: not run"
    return dict(
        pages=PAR_PAGES, global_batch=PAR_B, ranks=2, backend="gloo",
        train=dict(seconds=train_s, launches=launches),
        eval=dict(seconds=eval_s, launches=eval_launches,
                  test_rows=len(one) - 1, equal_to_one_process=True),
        steps=dict(batch=PAR_B, P=P, timing=PAR_TIMING,
                   single={dt: dict(ms_per_step=x["ms_per_step"],
                                    loss_sum=x["loss_sum"],
                                    launches=x["launches"])
                           for dt, x in singles.items()},
                   single_halves_swapped=swapped,
                   gloo_one_card=steps, grad_rtol=GRAD_RTOL,
                   grad_atol=GRAD_ATOL, spread_margin=PAR_SPREAD_MARGIN,
                   loss_rtol=PAR_LOSS_RTOL),
        nccl=nccl,
    )


def check_prefetcher(torch, dev, cfg):
    """The trainer's path to the device: every prefetched batch equals its
    host batch byte for byte, and a first train step fed by the prefetcher
    has the loss of the same step fed with the host batch."""
    import numpy as np

    from cova_tpu_torch.data.device_prefetch import device_prefetch
    from cova_tpu_torch.data.pipeline import make_pipelines
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import create_train_state, train_step

    ds = InMemoryWebDataset(4 * TRAIN_B, IMG, seed=SEED + 2,
                            max_boxes=cfg.max_boxes)
    train_p, _, _ = make_pipelines(cfg, ds, ds, ds)
    n_bytes, first = 0, None
    for _, batch, on_device in device_prefetch(train_p.epoch(1), dev):
        for name, host, t in zip(batch._fields, batch, on_device):
            need(t.device.type == "cuda", f"{name} is on {t.device}")
            need(np.array_equal(t.cpu().numpy(), host) and
                 t.cpu().numpy().dtype == host.dtype,
                 f"prefetched {name} differs from the host batch")
            n_bytes += host.nbytes
        if first is None:
            first = (batch, on_device)
    losses = []
    for fed in first:
        state = create_train_state(build_model(cfg, device=dev), cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        losses.append(float(train_step(state, fed, gen)["loss_sum"]))
    need(abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[0]),
         f"first-step loss {losses[1]} through the prefetcher, {losses[0]} "
         f"without")
    return dict(batches=4, bytes_compared=n_bytes, loss_host_fed=losses[0],
                loss_prefetched=losses[1])


def timed_forward(torch, model, batch, reps=10):
    from cova_tpu_torch.train.steps import forward_step

    out = forward_step(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        forward_step(model, batch)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def timed_steps(torch, cfg, dev, batch, sd=None, reps=10, warmup=2):
    """ms per train step (Adam included) on a fixed batch from the seeded
    init (or ``sd``), the last loss, and peak memory over the timed steps."""
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import create_train_state, train_step

    state = create_train_state(build_model(cfg, device=dev), cfg)
    if sd is not None:
        state.model.load_state_dict(sd)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    losses = [float(train_step(state, batch, gen)["loss_sum"])
              for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        m = train_step(state, batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    return dict(ms_per_step=ms, first_loss=losses[0],
                last_loss=float(m["loss_sum"]),
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def compare_logits(torch, dev, batch, got, want, steps, what):
    """Masked logits within ``steps`` bf16 steps (2^-8 relative each) of the
    largest logit, and the same retrieval picks on every page; returns the
    comparison's numbers."""
    mask = torch.from_numpy(batch.box_mask).to(dev)
    need(bool(torch.isfinite(got[mask]).all()), f"{what}: non-finite logits")
    top = float(want[mask].abs().max())
    tol = steps * 2.0 ** -8 * top
    diff = float((got - want)[mask].abs().max())
    neg = torch.tensor(float("-inf"), device=dev)
    picks = [torch.where(mask[..., None], lg, neg).argmax(1)[:, 1:]
             for lg in (got, want)]
    agree = float((picks[0] == picks[1]).float().mean())
    need(diff <= tol, f"{what}: logits differ by {diff} (tolerance {tol})")
    need(agree == 1.0, f"{what}: retrieval picks agree on {agree:.1%} only")
    return dict(logits_max_abs_diff=diff, largest_logit=top, logit_tol=tol,
                mean_abs_diff=float((got - want)[mask].abs().mean()),
                pick_agreement=agree)


# Logits of the hand-written conv path against cuDNN's, bf16: both sum in
# f32 and round once, in another order, so single conv outputs differ by one
# bf16 step (2^-8 relative). With the seeded random weights the logits reach
# about 30, where a step is 0.125; measured, the kernel path, cuDNN's and
# the plain nine-product conv's logits differ from each other by exactly
# one such step at most (mean 8e-4) and from an f32 forward by two. Allowed:
# two steps of the largest logit for the five-conv stem, eight for the
# seventeen convs of the full resnet18.
CONV_LOGIT_STEPS = 2
DEEP_LOGIT_STEPS = 8
F32_GRAD_MAX = 0.1


def phase_conv(torch, dev, tmp):
    """The hand-written conv path at full width: with ``COVA_CUDA_CONV=1`` every
    stride-1 3x3 conv of ``resnet18_stem`` runs K7, in serving (B = 10),
    in ``cli train`` (B = 5) and in a timed train step; results are held
    against the opt-in-off run from the same weights. Then the shoot-out of
    K7, K8 and cuDNN on a served feature map."""
    import numpy as np
    import torch.nn.functional as F

    from cova_tpu_torch import cli
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.ops.conv3x3 import (
        conv3x3,
        conv3x3_reference,
        conv3x3_roll,
    )
    from cova_tpu_torch.train.steps import forward_step

    cfg = Config(img_height=IMG)
    pth = os.path.join(tmp, "saved_model.pth")
    torch.save(random_state_dict(torch, cfg), pth)
    model = cli.load_model(cfg, dev, pth)
    ds = InMemoryWebDataset(B, IMG, seed=SEED, max_boxes=cfg.max_boxes)
    _, batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))
    batch, _ = pad_batch(batch, B)

    zero_counts()
    off, ms_off = timed_forward(torch, model, batch)
    need(not any(launch_counts()[k] for k in ("conv3x3_fwd",
                                              "conv3x3_roll_fwd")),
         "a conv kernel launched with the opt-in off")
    zero_counts()
    with conv_opt_in():
        on = forward_step(model, batch)
        torch.cuda.synchronize()
        per_forward = launch_counts()["conv3x3_fwd"]
    with conv_opt_in(watch=False):
        _, ms_on = timed_forward(torch, model, batch)
    need(per_forward == 5, f"K7 launched {per_forward} times per forward, "
                           f"expected 5")
    serve = dict(ms_per_batch=ms_on, ms_per_batch_opt_in_off=ms_off,
                 pages_per_s=B / (ms_on / 1e3), k7_per_forward=per_forward,
                 vs_opt_in_off=compare_logits(
                     torch, dev, batch, on.logits, off.logits,
                     CONV_LOGIT_STEPS, "conv path serving"))

    # cli train, one epoch, with the opt-in set.
    out = os.path.join(tmp, "conv_train")
    zero_counts()
    t0 = time.perf_counter()
    with conv_opt_in():
        rc = cli.main(["train", "--synthetic", str(TRAIN_PAGES),
                       "--img_height", str(IMG), "--output_dir", out,
                       "-e", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    need(rc == 0, f"train under the opt-in returned {rc}")
    n = launch_counts()
    fwd, bwd = n["bn_relu_pool_fwd"], n["bn_relu_pool_bwd"]
    need(bwd > 0 and n["conv3x3_fwd"] == 5 * fwd + 4 * bwd,
         f"K7 launched {n['conv3x3_fwd']} times over {fwd} forwards and "
         f"{bwd} backwards; expected 5 per forward and 4 per backward")
    with open(os.path.join(out, cfg.params_key, "Fold-1 logs.txt")) as f:
        losses = [float(line.split("Loss:")[1].split()[0])
                  for line in f if line.startswith("Epoch:")]
    need(len(losses) == 1 and np.isfinite(losses[0]), f"losses {losses}")
    train_launches = dict(n)

    # The timed step and one step's gradients, opt-in on against off.
    tb = fixed_train_batch(cfg)
    with conv_opt_in():
        step_on = timed_steps(torch, cfg, dev, tb)
    step_off = timed_steps(torch, cfg, dev, tb)
    # One step's gradients from one set of weights through three convs:
    # the kernel (opt-in on), cuDNN (off) and the plain nine-product conv
    # with the kernel's gradient rule. The train phase's tolerance
    # (GRAD_RTOL) is made for runs that share their forward bit for bit;
    # these do not, and a training loss has kinks: among ~10^6 ReLU inputs
    # and pooled maxima some lie within a rounding of theirs, and a unit
    # that changes sides moves gradient entries by percents.
    #   f32 (TF32 off): the kernel and the plain conv differ only in the
    # order of f32 sums, and their gradients must agree at GRAD_RTOL. cuDNN's
    # f32 conv rounds differently from both (measured: 2.3% on one tensor
    # against either, 0.4% between the two), so against cuDNN the kernel
    # path may not be farther than the plain conv is, with a tenth of
    # margin, nor farther than F32_GRAD_MAX of a tensor's largest gradient.
    #   bf16: any two of the three forwards are a bf16 step apart, which
    # moves winners of the bf16 max-pools and whole gradient paths with
    # them (measured 5-24% between any two, and with the wgmma kernels
    # shares of the tolerance of 9.95, 10.19 and 9.76 for the three pairs:
    # three draws from one spread); the kernel path may be half again as
    # far from cuDNN as the plain conv is, no more.
    from cova_tpu_torch.ops import conv3x3 as conv_mod

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    grads = {}
    for dtype in ("float32", "bfloat16"):
        dcfg = cfg.replace(compute_dtype=dtype)
        probe = build_model(dcfg, device=dev)
        sd = {k: v.clone() for k, v in probe.state_dict().items()}
        before = launch_counts()["conv3x3_fwd"]
        with conv_opt_in():
            loss_on, g_on = step_grads(torch, probe, sd, tb, SEED)
        need(launch_counts()["conv3x3_fwd"] - before == 9,
             "K7 did not launch 5 + 4 times in one forward and backward")
        loss_off, g_off = step_grads(torch, probe, sd, tb, SEED)
        before = launch_counts()["conv3x3_fwd"]
        with conv_opt_in(watch=False), mock.patch.object(
                conv_mod, "conv3x3", conv_mod.conv3x3_plain):
            _, g_plain = step_grads(torch, probe, sd, tb, SEED)
        need(launch_counts()["conv3x3_fwd"] == before,
             "K7 launched in the plain-conv run")
        if dtype == "float32":  # reported, not held: where exact lies
            with conv_opt_in(watch=False), mock.patch.object(
                    conv_mod, "conv3x3",
                    lambda x, w: conv_float64(torch, x, w)):
                _, g_exact = step_grads(torch, probe, sd, tb, SEED)
            vs_float64 = {name: grad_diff(g, g_exact)["share_of_tolerance"]
                          for name, g in (("opt_in", g_on), ("cudnn", g_off),
                                          ("plain_conv", g_plain))}
            del g_exact
        need(abs(loss_on - loss_off) <= 1e-3 * abs(loss_off),
             f"{dtype} train losses {loss_on} (opt-in) vs {loss_off}")
        row = dict(loss_opt_in=loss_on, loss_opt_in_off=loss_off,
                   vs_opt_in_off=grad_diff(g_on, g_off),
                   vs_plain_conv=grad_diff(g_on, g_plain),
                   cudnn_vs_plain_conv=grad_diff(g_off, g_plain),
                   elements_beyond_1e_3_vs_opt_in_off=grad_element_share(
                       g_on, g_off),
                   elements_beyond_1e_3_vs_plain_conv=grad_element_share(
                       g_on, g_plain))
        if dtype == "float32":
            row["share_of_tolerance_vs_float64_conv"] = vs_float64
        share = {k: row[k]["share_of_tolerance"] for k in (
            "vs_opt_in_off", "vs_plain_conv", "cudnn_vs_plain_conv")}
        if dtype == "float32":
            ok = (share["vs_plain_conv"] <= 1.0
                  and share["vs_opt_in_off"]
                  <= 1.1 * share["cudnn_vs_plain_conv"] + 1.0
                  and row["vs_opt_in_off"]["max_rel_diff"] <= F32_GRAD_MAX)
        else:
            ok = share["vs_opt_in_off"] <= max(
                1.0, 1.5 * share["cudnn_vs_plain_conv"])
        need(ok, f"{dtype} gradients under the opt-in differ beyond the "
                 f"tolerance: {row}")
        grads[dtype] = row
        del probe, sd, g_on, g_off, g_plain
    torch.backends.cudnn.allow_tf32 = tf32

    # Shoot-out on a served feature map: layer1's input and its first conv.
    layer1 = getattr(model.convnet, "4")
    captured = []
    hook = layer1[0].register_forward_pre_hook(
        lambda mod, args: captured.append(args[0]))
    forward_step(model, batch)
    hook.remove()
    with torch.inference_mode():
        fm = captured[0]  # [10, 320, 320, 64]
        need(tuple(fm.shape) == CONV_LAYER1[:4], f"layer1 input "
                                                 f"{tuple(fm.shape)}")
        w = layer1[0].conv1.weight.detach()
        k = w.permute(2, 3, 1, 0).contiguous()
        want = conv3x3_reference(fm, k)
        w16 = w.to(fm.dtype)
        nchw = fm.permute(0, 3, 1, 2)
        shoot = {}
        for name, fn in (
                ("conv3x3_fwd", lambda: conv3x3(fm, k)),
                ("conv3x3_roll_fwd", lambda: conv3x3_roll(fm, k)),
                ("library", lambda: F.conv2d(nchw, w16, padding=1)
                 .permute(0, 2, 3, 1))):
            cmp_ = conv_compare(torch, fn().contiguous(), want,
                                f"shoot-out {name}")
            shoot[name] = dict(ms=cuda_ms(torch, fn, reps=10, warmup=2),
                               **cmp_)
    launches = {"conv3x3_fwd": train_launches["conv3x3_fwd"],
                "conv3x3_roll_fwd": launch_counts()["conv3x3_roll_fwd"]}
    need(launches["conv3x3_roll_fwd"] > 0, "K8 was not launched")
    return launches, dict(
        serve=serve, train_wall_s=wall, epoch_loss=losses[0],
        train_launches=train_launches, step=step_on,
        step_opt_in_off=step_off, step_gradients=grads,
        grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL, shoot_out=shoot,
    )


def phase_backbones(torch, dev):
    """The full ``resnet18`` with the conv opt-in (K7 at C = 128, 256, 512)
    and ``resnet50_stem`` with and without ``COVA_REMAT=1``, at 640^2,
    B = 2, P = 232, bf16: a forward held against the plain-op path, and
    train steps with their time and peak memory."""
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.ops import conv3x3 as conv_mod
    from cova_tpu_torch.train.steps import forward_step

    size, b = 640, 2
    results = {}
    for name in ("resnet18", "resnet50_stem"):
        cfg = Config(img_height=size, backbone=name, batch_size=b,
                     eval_batch_size=b)
        ds = InMemoryWebDataset(b, size, seed=SEED, max_boxes=cfg.max_boxes)
        _, batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))
        batch, _ = pad_batch(batch, b)
        model = build_model(cfg, device=dev)
        model.load_state_dict(random_state_dict(torch, cfg))
        with plain_ops():
            plain = forward_step(model, batch)
        row = dict(img=size, batch=b, P=batch.boxes.shape[1])
        if name == "resnet18":
            before = launch_counts()["conv3x3_fwd"]
            with conv_opt_in():
                out = forward_step(model, batch)
                torch.cuda.synchronize()
                row["k7_per_forward"] = (launch_counts()["conv3x3_fwd"]
                                         - before)
                need(row["k7_per_forward"] == 14,
                     f"K7 launched {row['k7_per_forward']} times in a "
                     f"resnet18 forward, expected 14")
                before = launch_counts()["conv3x3_fwd"]
                row["step_opt_in"] = timed_steps(torch, cfg, dev, batch,
                                                 reps=3, warmup=1)
                per_step = (launch_counts()["conv3x3_fwd"] - before) // 4
                need(per_step == 27, f"K7 launched {per_step} times per "
                                     f"resnet18 train step, expected 27")
            row["step"] = timed_steps(torch, cfg, dev, batch, reps=3,
                                      warmup=1)
            # The same four steps again under cuDNN, and in f32 (TF32 off)
            # through three correct convs: cuDNN, K7 and the plain
            # nine-product conv. How far the last loss moves between two
            # runs of one path and between correct convs, beside the gap
            # between K7 and cuDNN.
            row["step_again"] = timed_steps(torch, cfg, dev, batch, reps=3,
                                            warmup=1)
            f32 = cfg.replace(compute_dtype="float32")
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                with conv_opt_in():
                    row["step_opt_in_f32"] = timed_steps(
                        torch, f32, dev, batch, reps=3, warmup=1)
                row["step_f32"] = timed_steps(torch, f32, dev, batch, reps=3,
                                              warmup=1)
                before = launch_counts()["conv3x3_fwd"]
                with conv_opt_in(watch=False), mock.patch.object(
                        conv_mod, "conv3x3", conv_mod.conv3x3_plain):
                    row["step_plain_conv_f32"] = timed_steps(
                        torch, f32, dev, batch, reps=3, warmup=1)
                need(launch_counts()["conv3x3_fwd"] == before,
                     "K7 launched in the plain-conv run")
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            last = {k: row[k]["last_loss"] for k in (
                "step", "step_again", "step_opt_in", "step_f32",
                "step_opt_in_f32", "step_plain_conv_f32")}
            row["last_loss_gaps"] = dict(
                cudnn_run_to_run=abs(last["step"] - last["step_again"]),
                opt_in_vs_cudnn_bf16=abs(last["step_opt_in"] - last["step"]),
                bf16_vs_f32_cudnn=abs(last["step"] - last["step_f32"]),
                opt_in_vs_cudnn_f32=abs(last["step_opt_in_f32"]
                                        - last["step_f32"]),
                plain_vs_cudnn_f32=abs(last["step_plain_conv_f32"]
                                       - last["step_f32"]),
                opt_in_vs_plain_f32=abs(last["step_opt_in_f32"]
                                        - last["step_plain_conv_f32"]))
            steps = DEEP_LOGIT_STEPS
        else:
            out = forward_step(model, batch)
            row["step"] = timed_steps(torch, cfg, dev, batch, reps=3,
                                      warmup=1)
            with mock.patch.dict(os.environ, {"COVA_REMAT": "1"}):
                row["step_remat"] = timed_steps(torch, cfg, dev, batch,
                                                reps=3, warmup=1)
            a, r = row["step"], row["step_remat"]
            need(abs(a["first_loss"] - r["first_loss"])
                 <= 1e-5 * abs(a["first_loss"]),
                 f"first loss {r['first_loss']} with remat, "
                 f"{a['first_loss']} without")
            need(r["peak_memory_bytes"] < a["peak_memory_bytes"],
                 f"remat did not lower peak memory: {r} vs {a}")
            steps = CONV_LOGIT_STEPS
        for key in ("step", "step_again", "step_opt_in", "step_f32",
                    "step_opt_in_f32", "step_plain_conv_f32", "step_remat"):
            if key in row:
                need(row[key]["last_loss"] == row[key]["last_loss"],
                     f"{name} {key}: non-finite loss")
        need(tuple(out.logits.shape) == (b, batch.boxes.shape[1], 4),
             f"{name}: logits {tuple(out.logits.shape)}")
        row["vs_plain_ops"] = compare_logits(
            torch, dev, batch, out.logits, plain.logits, steps,
            f"{name} forward")
        results[name] = row
        del model
        torch.cuda.empty_cache()
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cova_tpu_torch.ops import _build  # fails outside the repo

    if sys.argv[1:2] == ["_cli_rank"]:  # a rank of the parallel phase
        return cli_rank(sys.argv[2], sys.argv[3:])

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
          "compiled": sorted(reports), "ptxas": ptxas,
          "conv": ptxas_report(reports.get("conv3x3", ""), (
              "conv3x3_fwd_bf16_kernel", "conv3x3_roll_fwd_bf16_kernel",
              "conv3x3_fwd_f32_kernel", "conv3x3_roll_fwd_f32_kernel")),
          # What ptxas says of the conv kernels' wgmma: where it serialized
          # them (none expected) or injected register fences (C7519).
          "conv_wgmma_notes": sorted({
              re.sub(r"around line \d+ ", "", line).split(" in function")[0]
              .strip() for line in reports.get("conv3x3", "").splitlines()
              if "gmma" in line.lower()}),
          "pool": {**ptxas_report(reports.get("roi_pool", ""), (
              "roi_pool_pyramid_kernel", "roi_pool_bins_kernel",
              "roi_pool_bwd_kernel")),
              **ptxas_report(reports.get("bn_pool", ""), (
                  "bn_relu_pool_fwd_kernel", "bn_relu_pool_bwd_kernel"))},
          "sass": sass_report(_build, {
              "bn_pool": "bn_relu_pool_fwd_kernel",
              "roi_pool": "roi_pool_bwd_kernel"})})

    # Phase names as arguments run those phases alone (for work on one of
    # them); the summary and the ok line come only from a whole run.
    phases = ("kernels", "conv_kernels", "serve", "train", "bench",
              "export", "visualize", "sweep", "parallel", "conv",
              "backbones")
    only = sys.argv[1:]
    need(all(p in phases for p in only), f"phases are {phases}")

    def wanted(name):
        return not only or name in only

    kernels, launches = {}, {}
    tp = time.perf_counter()

    def seconds():
        """Seconds since the last call: each phase line's own time."""
        nonlocal tp
        t, tp = tp, time.perf_counter()
        return tp - t

    if wanted("kernels"):
        k_results, k_checks = phase_kernels(torch, dev)
        kernels.update(k_results)
        emit({"phase": "kernels", "seconds": seconds(),
              "names": sorted(k_results), "results": k_results,
              "checks": k_checks})
    if wanted("conv_kernels"):
        conv_results, conv_checks = phase_conv_kernels(torch, dev)
        kernels.update(conv_results)
        emit({"phase": "conv_kernels", "seconds": seconds(),
              "results": conv_results,
              "checks": conv_checks, "tolerance": CONV_TOL,
              "peaks": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                        "bf16_ops_per_s": BF16_OPS_PER_S,
                        "f32_ops_per_s": F32_OPS_PER_S,
                        "tf32_ops_per_s": TF32_OPS_PER_S,
                        "source": "NVIDIA H100 SXM data sheet, dense"}})
    if wanted("serve"):
        seconds()
        with tempfile.TemporaryDirectory() as tmp:
            serve_launches, serve = phase_serve(torch, dev, tmp)
        emit({"phase": "serve", "seconds": seconds(),
              "launches": serve_launches, **serve})
    # train, export and visualize share the trained fold.
    with tempfile.TemporaryDirectory() as fold_tmp:
        if wanted("train"):
            seconds()
            train_launches, train = phase_train(torch, dev, fold_tmp)
            launches.update(train_launches)
            emit({"phase": "train", "seconds": seconds(),
                  "launches": train_launches, **train})
        if wanted("bench"):
            seconds()
            emit({"phase": "bench", **phase_bench(torch, dev),
                  "seconds": seconds()})
        if wanted("export"):
            seconds()
            emit({"phase": "export", **phase_export(torch, dev, fold_tmp),
                  "seconds": seconds()})
        if wanted("visualize"):
            seconds()
            emit({"phase": "visualize",
                  **phase_visualize(torch, dev, fold_tmp),
                  "seconds": seconds()})
    if wanted("sweep"):
        seconds()
        with tempfile.TemporaryDirectory() as tmp:
            emit({"phase": "sweep", **phase_sweep(torch, dev, tmp),
                  "seconds": seconds()})
    if wanted("parallel"):
        seconds()
        with tempfile.TemporaryDirectory() as tmp:
            emit({"phase": "parallel", **phase_parallel(torch, dev, tmp),
                  "seconds": seconds()})
    if wanted("conv"):
        seconds()
        with tempfile.TemporaryDirectory() as tmp:
            conv_launches, conv = phase_conv(torch, dev, tmp)
        launches.update(conv_launches)
        emit({"phase": "conv", "seconds": seconds(),
              "launches": conv_launches, **conv})
    if wanted("backbones"):
        seconds()
        emit({"phase": "backbones", **phase_backbones(torch, dev),
              "seconds": seconds()})
    if only:
        emit({"phases_run": only, "seconds": time.perf_counter() - t0})
        return 0

    # Launches on each kernel's main path, counted from 0 over that path's
    # run: K1-K6 over the train phase's `cli train` (the serve phase's
    # counts are in its own line), K7 over the conv phase's `cli train`
    # under the opt-in, K8 over the conv phase's shoot-out.
    # One row per TPU kernel: K2 and K4 (the plain-walk variants of K1 and
    # K3) compute the same functions and share their CUDA kernels' rows.
    csrc = "cova_tpu_torch/csrc/"
    meta = {
        "roi_pool_fwd": ("roi_pool.cu", "roi_pool_pallas.py:215"),
        "roi_pool_fwd_k2": ("roi_pool.cu", "roi_pool_pallas.py:130"),
        "roi_pool_bwd": ("roi_pool.cu", "roi_pool_pallas.py:521"),
        "roi_pool_bwd_k4": ("roi_pool.cu", "roi_pool_pallas.py:344"),
        "bn_relu_pool_fwd": ("bn_pool.cu", "bn_pool.py:75"),
        "bn_relu_pool_bwd": ("bn_pool.cu", "bn_pool.py:102"),
        "conv3x3_fwd": ("conv3x3.cu", "conv3x3.py:55"),
        "conv3x3_roll_fwd": ("conv3x3.cu", "conv3x3.py:92"),
    }
    rows = []
    for row_name, (src, rep) in meta.items():
        name = row_name.rsplit("_k", 1)[0]
        need(launches[name] > 0, f"{name} was not launched on its main path")
        k = kernels[name]
        rows.append({
            "name": row_name, "route": "cuda", "source": csrc + src,
            "replaces": "cova_tpu/ops/" + rep, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
        })
    emit({"kernels": rows, "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
