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
   which no kernel may launch. The step also runs twice from one state and
   one batch with the kernels: the line names the gradient tensors that
   differ bit for bit, each with its largest relative difference (an
   observation, not a check).

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
14. corpus: Fold-1 of the corpus clone cut to prefixes of the real
   ``splits/Fold-1`` lists (40 train, 10 val, 10 test pages with their
   domains): ``scripts/make_corpus_clone_torch.py`` writes the pages at
   512^2, then ``cli train -e 2`` runs at full width as a subprocess under
   ``COVA_RSS_LIMIT_GB=0.001``: the RSS watchdog must re-exec it once after
   epoch 1 and the new process resume at epoch 2 (two epoch lines, every
   artifact); K1, K3, K5 and K6 must launch before and after the re-exec
   (the wrapper writes its counts before it execs). The model's forward on
   a batch of the clone must hand K5 ys [5, 128, 128, 256] and K1 a map [5,
   128, 128, 64]. Then K1 and K5 are held bit-exact against their plain
   versions at 512^2 in bf16 and f32 for every box bucket (P = 64, 128,
   192, 232) at B = 5 and at a partial batch of one page, K3 and K6 under
   the kernels phase's rules, each with the plan its wrapper chose.

15. profile: ``cli train -e 1`` on 10 synthetic pages at full width with
   ``COVA_PROFILE_DIR`` set, the launch counts set to 0 before and read
   after: the trainer's hook must write one trace, named for rank 0, in
   which ``scripts/read_torch_trace.py`` finds K1 (``roi_pool_pyramid_kernel``
   or ``roi_pool_bins_kernel``), K3 (``roi_pool_bwd_kernel``), K5 and K6
   with device time; K3 and K6 as many times as their wrappers launched
   them (the epoch's backward passes, all inside the trace). The line holds
   the trace's device busy ms, idle share and device ms by category.

16. graphs: the step graphs (``train/graphs.py``) at full width (1280^2,
   P = 232, -cs 12, -hd 384, -bbhd 32, bf16). (a) From one state, 8 train
   steps at B = 5 alternating P = 128 and 232, the dropout generator
   re-seeded after the 4th (an epoch boundary), eagerly five times and
   through graphs: the first loss the same bits, each later loss within
   GRAD_RTOL of the eager one or 1.5 times the eager runs' spread (Adam
   amplifies the card's atomics from step to step), the parameters and BN
   buffers after step 8 within the train phase's gradient rule or 1.5
   times the farthest eager run's distance (Adam's moments reported);
   then through graphs again with each step started from the
   first eager run's state and generator position before it: every loss
   the same bits, the generator where the eager run's was, and the last
   step's state within the gradient rule; Adam's step count and every
   ``num_batches_tracked`` 8. (a) and (b) run under deterministic
   algorithms (``warn_only``; the ops that have none are listed) and
   cuDNN's deterministic convolutions, so that the atomics' order, which
   differs between eager runs and replays, does not set the spread; where
   the eager runs then agree bit for bit, the graphs' run must equal them
   in every loss and every tensor of the state.
   (b) The P = 232 train graph replayed 3 times
   from one state (parameters, Adam state and BN buffers put back in
   place), each loss the same bits as the eager step from that state at
   that generator position, the three losses different (the masks move).
   (c) The eval and forward graphs at P = 64, 128, 192 and 232, at B = 10
   and for a padded partial batch of 3 pages: correct and present flags,
   logits and attention weights the same bits as the eager steps'. (d) The
   launch counters after (a) and (c) equal the eager runs'. (e) Paired
   timings on the host clock (eager, graphs, graphs, eager, each on a fresh
   model): the train step at 1280^2 B = 5 and 8 and at 512^2 B = 5, the
   forward at B = 10 (staged and from host arrays) and 32: ms a step, CUDA
   events ms a step, the first two calls' seconds (the eager step and the
   capture), device busy ms under the profiler, peak allocated and reserved
   bytes, graphs held and capture seconds; printed, not checked. Checked:
   in each side's profiled calls, the trace's launches of K1's bins kernel,
   K5, K3 and K6 (through graphs: inside the replays) equal what the
   counters added, and each of the step's kernels was launched. The other
   phases run through graphs wherever the CLI runs on one card; a step
   under ``plain_ops()`` and a forward whose hooks must fire run with
   ``graphs=False``, and ``parallel`` stays eager (a mesh).

The train phase also feeds batches through the device prefetcher and holds
them against the host batches byte for byte. Every phase line carries its
seconds.

17. bn_act: K9 (``ops/bn_act.py``), eval-mode BN affine + residual +
   ReLU in one pass, at ResNet-50's bn3 + BN'd residual + ReLU shape (x
   and res [10, 320, 320, 256]), ResNet-18's bn1 + ReLU shape ([10, 320,
   320, 64]) and its bn2 + identity residual + ReLU shape (the same), in
   bf16 and f32: bit-exact against ``bn_act_plain``, ten timings each
   (median and spread) beside the bytes bound (x, res and out once at 3.35
   TB/s) and the plain version's time; and the K9 launches a batch of a
   graphed ResNet-50-stem ``forward_step`` at B = 10 (9: its eager run,
   capture and replay). ResNet-18's stem, the default, counts its 4 a
   batch in the serve phase's ``predict`` and the graphs phase's forwards.

18. window_attn: K10 (``ops/window_attn.py``), the Swin trunk's
   shifted-window attention, at its serving shape (qkv [10, 320, 320, 288]
   bf16: B = 10 at 1280^2) for shift 0 and 3 against
   ``window_attention_plain`` (within K10_TOL of the largest output), ten
   timings each beside the bytes bound (the qkv read and the output
   written once at 3.35 TB/s) and the plain version's time; the K10
   launches a batch of a graphed ``swin_t_stage1`` ``forward_step`` at B =
   10 (2: its eager run, capture and replay); and an eager forward under
   the profiler, in which no ``aten::roll`` runs.

19. layernorm: K11 (``ops/layernorm.py``), the Swin trunk's LayerNorm with
   the residual add before it folded in, at its serving map ([10, 320, 320,
   96] bf16) plain, with a residual, and with a residual and its sum
   written: the sum bit-exact and the output within one bf16 step of the
   largest |y| against ``layernorm_plain``, ten timings each beside the
   bytes bound (2, 3 and 4 maps at 3.35 TB/s), the plain version's time and
   ``F.layer_norm``'s (``library_ms``; the port never calls it), and the
   six a batch beside their 19 maps; then the K11 launches a batch of a
   graphed ``swin_t_stage1`` ``forward_step`` at B = 10 (6) and three
   replays under the profiler, whose trace must hold K11 six times a batch
   and no PyTorch LayerNorm kernel, with device ms a batch by kernel.

(Phases run in the order 1-3, 17, 18, 19, 6, 4, 5, 9-16, 7, 8.) Then it
prints the kernels' summary line (one row per TPU kernel, K1-K8), the
``nvidia-smi`` line, and, last,
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
# The corpus phase: pages of the corpus clone at its 512^2, for prefixes of
# the real splits/Fold-1 lists (train, val, test), trained for 2 epochs at
# full width in a subprocess whose RSS watchdog re-execs it after epoch 1;
# the kernels at 512^2 for every padded box count the corpus reaches
# (Config.box_buckets and pad_boxes), at the train batch and at a partial
# batch of one page.
CORPUS_IMG, CORPUS_SPLIT = 512, (40, 10, 10)
CORPUS_BUCKETS = (64, 128, 192, 232)
CORPUS_BATCHES = (TRAIN_B, 1)
CORPUS_TIMEOUT = 600
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
# The profile phase: one epoch of `cli train` at full width on 10 pages (a
# 6/2/2 split, two steps) under the trainer's COVA_PROFILE_DIR hook.
PROFILE_PAGES = 10


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


def check_bn_pool_bwd(torch, gen, shape, dtype, dev, tag):
    """K6 at ``shape`` (B, U, V, O) on tied inputs against its plain
    version: dys bit-exact; d(scale)/d(shift), f32 sums over the whole map
    in another order, within rtol 1e-4 plus 1e-4 of their largest value.
    Returns its arguments and the errors."""
    from cova_tpu_torch.ops.bn_pool import (
        bn_relu_pool_s2d_backward,
        bn_relu_pool_s2d_backward_reference,
    )

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
    # inputs (check_bn_pool_bwd).
    for dtype in (torch.bfloat16, torch.float32):
        for shape in BN_RAGGED:
            tag = "bn_relu_pool_bwd_" + "x".join(map(str, shape)) + f"_{dtype}"
            _, checks[tag] = check_bn_pool_bwd(torch, gen, shape, dtype,
                                               dev, tag)
            checks[tag]["plan"] = bwd_plan(dtype, *shape)._asdict()
    for dtype in (torch.bfloat16, torch.float32):
        shape = (TRAIN_B, h, w, 64)
        name = "bn_relu_pool_bwd" + ("" if dtype == torch.bfloat16 else "_f32")
        bargs, row = check_bn_pool_bwd(torch, gen, shape, dtype, dev, name)
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


# The K9 phase's shapes: (row, map shape, residual, ReLU).
BN_ACT_SHAPES = (("r50_bn3_res_bn_relu", (B, IMG // 4, IMG // 4, 256), "bn",
                  True),
                 ("r18_bn1_relu", (B, IMG // 4, IMG // 4, 64), "none", True),
                 ("r18_bn2_res_relu", (B, IMG // 4, IMG // 4, 64), "identity",
                  True))
# K9 launches a forward of each trunk: two BasicBlocks, three Bottlenecks.
BN_ACT_PER_BATCH = {"resnet18_stem": 4, "resnet50_stem": 9}


def phase_bn_act(torch, dev):
    """K9 at the trunks' shapes against ``bn_act_plain`` and the bytes
    bound; and its launches a batch of a graphed ResNet-50-stem forward."""
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.ops import bn_act as k9
    from cova_tpu_torch.train.steps import forward_step

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for row, shape, res_kind, relu in BN_ACT_SHAPES:
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            res = (None if res_kind == "none" else
                   torch.randn(shape, generator=gen, device=dev).to(dtype))
            coef = [torch.rand(c, generator=gen, device=dev) + 0.5,
                    torch.randn(c, generator=gen, device=dev)]
            rcoef = ([None, None] if res_kind != "bn" else
                     [torch.rand(c, generator=gen, device=dev) + 0.5,
                      torch.randn(c, generator=gen, device=dev)])
            kw = dict(relu=relu, res=res, res_scale=rcoef[0],
                      res_shift=rcoef[1])
            got = k9.bn_act(x, *coef, **kw)
            want = k9.bn_act_plain(x, *coef, **kw)
            torch.cuda.synchronize()
            need(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
                 f"bn_act {row} {dtype} differs from its plain version")
            del got, want
            n_bytes = x.numel() * x.element_size() * (
                2 if res is None else 3) + 4 * c * (2 if res_kind != "bn"
                                                     else 4)
            n_ops = x.numel() * (3 if res is None else
                                 (4 if res_kind == "identity" else 6))
            bms, by = bound_ms(n_bytes, n_ops)
            t = timings(torch, lambda: k9.bn_act(x, *coef, **kw), reps=20)
            name = f"bn_act_{row}" + ("" if dtype == torch.bfloat16
                                      else "_f32")
            results[name] = dict(
                **t, plain_ms=cuda_ms(
                    torch, lambda: k9.bn_act_plain(x, *coef, **kw), reps=3),
                bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
                achieved_gb_per_s=n_bytes / t["ms"] / 1e6,
                bound_share=bms / t["ms"],
                plan=k9.launch_plan(x.numel(), c, True)._asdict(),
                shape=list(shape), dtype=str(dtype))
            del x, res
            torch.cuda.empty_cache()

    # ResNet-50's stem as its serving cell runs it: B = 10 at 1280^2
    # through the forward graph (eager, capture + replay, replay).
    cfg = Config(img_height=IMG, backbone="resnet50_stem")
    ds = InMemoryWebDataset(B, IMG, seed=SEED, max_boxes=cfg.max_boxes)
    batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))[1]
    batch = pad_batch(batch, B)[0]
    model = build_model(cfg, device=dev)
    calls = 3
    before = launch_counts()
    for _ in range(calls):
        forward_step(model, batch)
    torch.cuda.synchronize()
    per_batch = (launch_counts()["bn_act"] - before["bn_act"]) / calls
    need(per_batch == BN_ACT_PER_BATCH[cfg.backbone],
         f"{cfg.backbone}: {per_batch} K9 launches a batch, expected "
         f"{BN_ACT_PER_BATCH[cfg.backbone]}")
    del model
    torch.cuda.empty_cache()
    return results, {cfg.backbone: per_batch}


# K10 against its plain version: the largest gap within 2^-6 of the
# largest output. The kernel rounds P to bf16 before P v (2^-9 a weight)
# and its output to bf16 (2^-9), where the plain version stays f32.
K10_TOL = 2.0 ** -6
K10_PER_BATCH = 2


def phase_window_attn(torch, dev):
    """K10 at the Swin trunk's serving shape against
    ``window_attention_plain`` and the bytes bound; its launches a batch of
    a graphed ``swin_t_stage1`` forward; no roll in an eager forward."""
    from torch.profiler import ProfilerActivity, profile

    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.ops import window_attn as k10
    from cova_tpu_torch.train.steps import forward_step

    gen = torch.Generator(device=dev).manual_seed(SEED)
    side = IMG // 4
    shape = (B, side, side, 3 * k10.HEADS * k10.HEAD_DIM)
    windows = B * k10.padded_side(side) ** 2 // k10.WINDOW ** 2
    n = k10.WINDOW ** 2
    index = k10.relative_position_index().to(dev)
    results = {}
    for shift in (0, k10.WINDOW // 2):
        qkv = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        table = torch.randn((2 * k10.WINDOW - 1) ** 2, k10.HEADS,
                            generator=gen, device=dev)
        bias = k10.relative_bias(table, index)
        pad = torch.randn(shape[-1], generator=gen, device=dev).to(
            torch.bfloat16)
        got = k10.window_attention(qkv, bias, pad, shift).float()
        want = k10.window_attention_plain(qkv, bias, pad, shift).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        need(err <= K10_TOL, f"window_attn shift {shift}: largest gap "
             f"{err} of the largest output, over {K10_TOL}")
        n_bytes = (qkv.numel() + got.numel()) * 2 + bias.numel() * 4 \
            + pad.numel() * 2
        n_ops = 2 * 2 * windows * n * n * shape[-1] // 3
        del got, want
        bms, by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        t = timings(torch, lambda: k10.window_attention(qkv, bias, pad,
                                                        shift), reps=20)
        results[f"window_attn_shift{shift}"] = dict(
            **t, max_rel_err=err, tolerance=K10_TOL,
            plain_ms=cuda_ms(torch, lambda: k10.window_attention_plain(
                qkv, bias, pad, shift), reps=2),
            bound_ms=bms, bound_by=by, bytes=n_bytes, operations=n_ops,
            achieved_gb_per_s=n_bytes / t["ms"] / 1e6,
            bound_share=bms / t["ms"], shape=list(shape))
        del qkv
        torch.cuda.empty_cache()

    # The trunk as its serving cell runs it: B = 10 at 1280^2 through the
    # forward graph (eager, capture + replay, replay), then one eager
    # forward under the profiler.
    cfg = Config(img_height=IMG, backbone="swin_t_stage1")
    ds = InMemoryWebDataset(B, IMG, seed=SEED, max_boxes=cfg.max_boxes)
    batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))[1]
    batch = pad_batch(batch, B)[0]
    model = build_model(cfg, device=dev)
    calls = 3
    before = launch_counts()
    for _ in range(calls):
        forward_step(model, batch)
    torch.cuda.synchronize()
    per_batch = (launch_counts()["window_attn"] - before["window_attn"]) \
        / calls
    need(per_batch == K10_PER_BATCH, f"swin_t_stage1: {per_batch} K10 "
         f"launches a batch, expected {K10_PER_BATCH}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward_step(model, batch, graphs=False)
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()}
    need("aten::roll" not in ops, "a roll ran in the swin forward")
    kernels = sorted(k for k in ops if "window_attn" in k)
    need(kernels, "no window_attn kernel in the profiled forward")
    del model
    torch.cuda.empty_cache()
    return results, {"swin_t_stage1": per_batch, "profiled_kernels": kernels,
                     "pad_ops": ops.get("aten::constant_pad_nd", 0)}


K11_PER_BATCH = 6
K11_EPS = 1e-5  # nn.LayerNorm's default, the trunk's
# (row, residual, sum written, maps read and written)
K11_MODES = (("plain", False, False, 2), ("res", True, False, 3),
             ("res_sum", True, True, 4))
# The trunk's six a batch by mode: patch_embed.norm and block 1's norm1
# plain, three with the sum written, norm0 with a residual and no sum.
K11_TRUNK = {"plain": 2, "res_sum": 3, "res": 1}


def bf16_step(top: float) -> float:
    """One bf16 step (2^-7 of the binade) at |value| ``top``: the most two
    roundings to bf16 of f32 numbers a few f32 steps apart can differ."""
    import math

    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def kernel_ms(prof, n):
    """Device ms and launches a run of each kernel, copy and set in a
    profile of ``n`` runs, by name."""
    rows = {}
    for e in device_events(prof):
        row = rows.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    return {k: dict(ms=us / 1e3 / n, launches=count / n)
            for k, (us, count) in rows.items()}


def phase_layernorm(torch, dev):
    """K11 at the Swin trunk's serving map against ``layernorm_plain``, its
    bytes bound and ``F.layer_norm``; its launches a batch of a graphed
    ``swin_t_stage1`` forward; no PyTorch LayerNorm kernel in the trace."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.ops import layernorm as k11
    from cova_tpu_torch.train.steps import forward_step

    gen = torch.Generator(device=dev).manual_seed(SEED)
    c = k11.CHANNELS
    shape = (B, IMG // 4, IMG // 4, c)
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(
        torch.bfloat16)
    res = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.rand(c, generator=gen, device=dev) * 0.4 + 0.8
    b = torch.rand(c, generator=gen, device=dev) * 0.2 - 0.1
    wb = (w.to(torch.bfloat16), b.to(torch.bfloat16))
    n_map = x.numel() * x.element_size()
    library_ms = cuda_ms(torch, lambda: F.layer_norm(
        x, (c,), *wb, K11_EPS), reps=5)
    results = {}
    for row, with_res, sum_out, maps in K11_MODES:
        r = res if with_res else None
        got = k11.layernorm(x, w, b, K11_EPS, r, sum_out=sum_out)
        want = k11.layernorm_plain(x, w, b, K11_EPS, r, sum_out=sum_out)
        torch.cuda.synchronize()
        if sum_out:
            (got, got_s), (want, want_s) = got, want
            need(torch.equal(got_s.view(torch.int16),
                             want_s.view(torch.int16)),
                 f"layernorm {row}: the sum differs from x + res")
            del got_s, want_s
        top = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        need(err <= bf16_step(top), f"layernorm {row}: largest gap {err}, "
             f"over one bf16 step at {top}")
        not_equal = float((got != want).float().mean())
        del got, want
        n_bytes = maps * n_map + 2 * c * 4
        # An element: the sum, a centred square (3), the normalisation (4),
        # and the residual's add.
        n_ops = x.numel() * (8 + int(with_res))
        bms, by = bound_ms(n_bytes, n_ops)
        t = timings(torch, lambda: k11.layernorm(
            x, w, b, K11_EPS, r, sum_out=sum_out), reps=20)
        results[f"layernorm_{row}"] = dict(
            **t, max_abs_err=err, largest=top, tolerance=bf16_step(top),
            not_bit_equal=not_equal,
            plain_ms=cuda_ms(torch, lambda: k11.layernorm_plain(
                x, w, b, K11_EPS, r, sum_out=sum_out), reps=5),
            library_ms=library_ms, bound_ms=bms, bound_by=by, bytes=n_bytes,
            operations=n_ops, achieved_gb_per_s=n_bytes / t["ms"] / 1e6,
            bound_share=bms / t["ms"], shape=list(shape))
        torch.cuda.empty_cache()
    trunk_ms = sum(n * results[f"layernorm_{row}"]["ms"]
                   for row, n in K11_TRUNK.items())
    trunk_bound = sum(n * results[f"layernorm_{row}"]["bound_ms"]
                      for row, n in K11_TRUNK.items())
    results["trunk_batch"] = dict(
        ms=trunk_ms, bound_ms=trunk_bound, bound_share=trunk_bound / trunk_ms,
        launches=sum(K11_TRUNK.values()),
        plain_ms=sum(n * results[f"layernorm_{row}"]["plain_ms"]
                     for row, n in K11_TRUNK.items()))
    del x, res
    torch.cuda.empty_cache()

    # The trunk as its serving cell runs it: B = 10 at 1280^2 through the
    # forward graph (eager, capture + replay, replay), then three replays
    # under the profiler.
    cfg = Config(img_height=IMG, backbone="swin_t_stage1")
    ds = InMemoryWebDataset(B, IMG, seed=SEED, max_boxes=cfg.max_boxes)
    batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))[1]
    batch = pad_batch(batch, B)[0]
    model = build_model(cfg, device=dev)
    calls = 3
    before = launch_counts()
    for _ in range(calls):
        forward_step(model, batch)
    torch.cuda.synchronize()
    per_batch = (launch_counts()["layernorm"] - before["layernorm"]) / calls
    need(per_batch == K11_PER_BATCH, f"swin_t_stage1: {per_batch} K11 "
         f"launches a batch, expected {K11_PER_BATCH}")
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            forward_step(model, batch)
        torch.cuda.synchronize()
    counted = (launch_counts()["layernorm"] - before["layernorm"]) / calls
    kernels = kernel_ms(prof, calls)
    k11_traced = sum(v["launches"] for k, v in kernels.items()
                     if "swin_layernorm_kernel" in k)
    need(k11_traced == counted == K11_PER_BATCH,
         f"swin_t_stage1 graphed: K11 {k11_traced} times a batch in the "
         f"trace, {counted} counted, expected {K11_PER_BATCH}")
    torch_ln = sorted(k for k in kernels if "layer_norm" in k.lower())
    need(not torch_ln, f"PyTorch LayerNorm kernels in the forward: "
         f"{torch_ln}")
    del model
    torch.cuda.empty_cache()
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12]
    return results, {
        "swin_t_stage1": per_batch, "traced_per_batch": k11_traced,
        "device_ms_per_batch": sum(v["ms"] for v in kernels.values()),
        "k11_ms_per_batch": sum(v["ms"] for k, v in kernels.items()
                                if "swin_layernorm_kernel" in k),
        "elementwise_ms_per_batch": sum(
            v["ms"] for k, v in kernels.items() if "elementwise_kernel" in k),
        "kernels_by_ms": {k[:90]: v for k, v in top}}


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


def launch_counts():
    """Each kernel wrapper's launch count (``ops/launches.py``; a step
    graph's replay adds the counts its capture recorded)."""
    from cova_tpu_torch.ops import launches

    return launches.counts()


def zero_counts() -> None:
    from cova_tpu_torch.ops import launches

    launches.zero()


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """Deterministic algorithms inside (``warn_only``: an op that has none
    warns and runs as it would) and cuDNN's deterministic convolutions.
    Yields a list that names, on the way out, each op that had none."""
    import warnings

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    ops = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            yield ops
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
            torch.backends.cudnn.deterministic = was[2]
            ops.extend(sorted({
                str(w.message).split(" does not have")[0] for w in caught
                if "deterministic implementation" in str(w.message)}))


@contextlib.contextmanager
def plain_ops():
    """The model's kernel ops swapped for their plain (forward, backward)
    pairs, with the conv opt-in off; fails unless no kernel launched
    meanwhile, so a moved call site cannot make the plain run compare the
    kernels with themselves (a step inside runs with ``graphs=False``: a
    graph captured with the kernels would replay them)."""
    from cova_tpu_torch.models import cova as cova_mod
    from cova_tpu_torch.models import resnet as resnet_mod
    from cova_tpu_torch.ops.bn_act import bn_act_plain
    from cova_tpu_torch.ops.bn_pool import bn_relu_pool_s2d_plain
    from cova_tpu_torch.ops.roi_pool import roi_pool_plain

    before = launch_counts()
    with mock.patch.object(cova_mod, "roi_pool", roi_pool_plain), \
            mock.patch.object(resnet_mod, "bn_relu_pool_s2d",
                              bn_relu_pool_s2d_plain), \
            mock.patch.object(resnet_mod, "bn_act", bn_act_plain), \
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
                if k in ("roi_pool_fwd", "bn_relu_pool_fwd", "bn_act")}
    need(rc == 0, f"predict returned {rc}")
    need(all(n > 0 for n in launches.values()),
         f"a kernel was not launched on the main path: {launches}")
    n_batches = -(-MAX_PAGES // cfg.eval_batch_size)
    k9_per_batch = launches["bn_act"] / n_batches
    need(k9_per_batch == BN_ACT_PER_BATCH[cfg.backbone],
         f"predict launched K9 {k9_per_batch} times a batch, expected "
         f"{BN_ACT_PER_BATCH[cfg.backbone]}")
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
    forward_step(model, batch)  # captures the batch's graph
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        forward_step(model, batch)
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()  # the same batches eagerly, beside it
    for _ in range(reps):
        forward_step(model, batch, graphs=False)
    torch.cuda.synchronize()
    ms_batch_eager = (time.perf_counter() - t0) / reps * 1e3
    with plain_ops():
        t0 = time.perf_counter()
        plain = forward_step(model, batch, graphs=False)
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
        predict_wall_s=wall, pages=MAX_PAGES, batches=n_batches,
        bn_act_launches_per_batch=k9_per_batch, ms_per_batch=ms_batch,
        ms_per_batch_eager=ms_batch_eager,
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


def grads_not_bit_equal(torch, a, b):
    """The f32 gradient tensors of ``a`` whose bits differ from ``b``'s,
    each with its largest difference relative to the tensor's largest
    gradient and the number of elements that differ."""
    out = {}
    for k in b:
        ai, bi = a[k].view(torch.int32), b[k].view(torch.int32)
        if not torch.equal(ai, bi):
            top = float(b[k].abs().max())
            d = float((a[k] - b[k]).abs().max())
            out[k] = {"max_rel_diff": d / top if top else d,
                      "elements": int((ai != bi).sum())}
    return out


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

    # One train step on a fixed batch, timed; peak memory from its first step.
    batch = fixed_train_batch(cfg)
    need(batch.boxes.shape[1] == P, f"train batch has P={batch.boxes.shape[1]}")
    state = create_train_state(build_model(cfg, device=dev), cfg)
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    # Over the eager step and the capture too: a replay allocates only its
    # copies (its working memory is the graph's pool).
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        train_step(state, batch, gen)
    torch.cuda.synchronize()
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
        # An observation, not a check: the tensors whose gradients two runs
        # of one step from one state and one batch do not give bit for bit.
        loss_rerun_bit_equal=loss_k2 == loss_k,
        grad_rerun_not_bit_equal=grads_not_bit_equal(torch, grads_k2,
                                                      grads_k),
        grad_tensors=len(grads_k),
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
        plain = forward_step(model, batch, graphs=False).logits
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

    real_execv = os.execv

    def execv(path, argv):
        """The RSS watchdog's re-exec (``cli._rss_restart``): this
        process's counts go to OUT.exec, and the new process runs this
        wrapper again with the same arguments plus ``--resume``."""
        with open(out + ".exec", "w") as f:
            json.dump({"rc": None, "launches": launch_counts()}, f)
        rest = argv[argv.index("cova_tpu_torch.cli") + 1:]
        real_execv(path, [path, os.path.abspath(__file__), "_cli_rank", out,
                          *rest])

    zero_counts()
    with mock.patch.object(os, "execv", execv):
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
    from cova_tpu_torch.parallel.launch import (
        rank_env, rendezvous_store, wait_all)

    store = rendezvous_store()
    procs, logs = [], []
    for r, cmd in enumerate(cmds):
        env = rank_env(r, len(cmds), store.port)
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


def bucket_boxes(torch, dev, b, p):
    """Boxes and masks of b hard-mode pages of the corpus clone's kind at
    CORPUS_IMG whose box counts fall in bucket p (above the next smaller
    bucket, at most 230 as in the corpus), padded to p."""
    import numpy as np

    from cova_tpu_torch.data.records import pad_page
    from cova_tpu_torch.data.synthetic import synth_record

    lo = max([q for q in CORPUS_BUCKETS if q < p], default=10) + 1
    pages = [pad_page(synth_record(str(i), CORPUS_IMG,
                                   np.random.default_rng((SEED, p, i)),
                                   min_boxes=lo, max_boxes=min(p, 230),
                                   hard=True), p, CTX)
             for i in range(b)]
    boxes = torch.from_numpy(np.stack([q.boxes_xyxy for q in pages])).to(dev)
    mask = torch.from_numpy(np.stack([q.box_mask for q in pages])).to(dev)
    return boxes, mask


def corpus_kernels(torch, dev):
    """K1, K3, K5 and K6 at the corpus's 512^2 (map and pooled stem [b,
    128, 128, 64], ys [b, 128, 128, 256]) against their plain versions, in
    bf16 and f32: K1 and K5 bit-exact, K3 and K6 under the kernels phase's
    rules (tied inputs; dfm and dys bit-exact, d(scale)/d(shift) within
    rtol 1e-4 plus 1e-4 of their largest value), for every box bucket and
    batch of CORPUS_BUCKETS x CORPUS_BATCHES; each with the plan its
    wrapper chose and, in bf16 at the train batch, its ms."""
    from cova_tpu_torch.ops.bn_pool import (
        bn_relu_pool_s2d,
        bn_relu_pool_s2d_reference,
        bwd_plan,
        fwd_plan,
    )
    from cova_tpu_torch.ops.roi_pool import (
        roi_bwd_plan,
        roi_pool,
        roi_pool_backward,
        roi_pool_backward_reference,
        roi_pool_plan,
        roi_pool_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = w = CORPUS_IMG // 4
    checks = {}

    def held(tag, got, want, plan, timed=None):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        need(err == 0.0, f"{tag} differs from its plain version by {err}")
        checks[tag] = dict(max_abs_err=err, plan=plan)
        if timed is not None:
            checks[tag]["ms"] = cuda_ms(torch, timed, reps=20, warmup=3)

    for dtype in (torch.bfloat16, torch.float32):
        isz = "bf16" if dtype == torch.bfloat16 else "f32"
        for b in CORPUS_BATCHES:
            time_it = b == TRAIN_B and dtype == torch.bfloat16
            for p in CORPUS_BUCKETS if b == TRAIN_B else CORPUS_BUCKETS[-1:]:
                boxes, mask = bucket_boxes(torch, dev, b, p)
                fm = tied(torch, gen, (b, h, w, 64), dtype, dev, 2.0)
                args = (fm, boxes, mask, 0.25)
                got = roi_pool(*args)
                want = roi_pool_reference(*args)
                held(f"roi_pool_fwd_{b}x{h}x{w}_P{p}_{isz}", got, want,
                     roi_pool_plan(dtype, b, p, h, w, 64, 3, 3)._asdict(),
                     (lambda: roi_pool(*args)) if time_it else None)
                g = torch.randn(want.shape, generator=gen,
                                device=dev).to(dtype)
                bargs = (fm, boxes, mask, want, g, 0.25)
                held(f"roi_pool_bwd_{b}x{h}x{w}_P{p}_{isz}",
                     roi_pool_backward(*bargs),
                     roi_pool_backward_reference(*bargs),
                     roi_bwd_plan(dtype, b, p, h, w, 64, 3, 3)._asdict(),
                     (lambda: roi_pool_backward(*bargs)) if time_it
                     else None)
            ys = torch.randn(b, h, w, 256, generator=gen, device=dev).to(dtype)
            scale = torch.rand(64, generator=gen, device=dev) + 0.5
            shift = torch.randn(64, generator=gen, device=dev)
            held(f"bn_relu_pool_fwd_{b}x{h}x{w}_{isz}",
                 bn_relu_pool_s2d(ys, scale, shift),
                 bn_relu_pool_s2d_reference(ys, scale, shift),
                 fwd_plan(dtype, b, h, w, 64)._asdict(),
                 (lambda: bn_relu_pool_s2d(ys, scale, shift)) if time_it
                 else None)
            tag = f"bn_relu_pool_bwd_{b}x{h}x{w}_{isz}"
            _, checks[tag] = check_bn_pool_bwd(torch, gen, (b, h, w, 64),
                                               dtype, dev, tag)
            checks[tag]["plan"] = bwd_plan(dtype, b, h, w, 64)._asdict()
    return checks


def corpus_shapes(torch, dev, clone, page_ids):
    """The shapes the model's forward gives K5 and K1 on a batch of the
    clone at full width (recorded through call-through wrappers)."""
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.dataset import WebDataset
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.models import cova as cova_mod
    from cova_tpu_torch.models import resnet as resnet_mod
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import forward_step

    cfg = Config(img_height=CORPUS_IMG)
    ds = WebDataset(clone, page_ids[:TRAIN_B], img_size=CORPUS_IMG)
    _, batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))
    batch, _ = pad_batch(batch, TRAIN_B)
    seen = {}

    def recorded(name, fn):
        def call(x, *args, **kw):
            seen[name] = [list(x.shape)] + [
                list(a.shape) for a in args[:1] if hasattr(a, "shape")]
            return fn(x, *args, **kw)
        return call

    model = build_model(cfg, device=dev).eval()
    with mock.patch.object(cova_mod, "roi_pool",
                           recorded("roi_pool", cova_mod.roi_pool)), \
            mock.patch.object(resnet_mod, "bn_relu_pool_s2d", recorded(
                "bn_relu_pool_s2d", resnet_mod.bn_relu_pool_s2d)), \
            torch.no_grad():
        forward_step(model, batch, graphs=False)
    torch.cuda.synchronize()
    u = CORPUS_IMG // 4
    need(seen.get("bn_relu_pool_s2d", [None])[0] == [TRAIN_B, u, u, 256],
         f"K5's input at {CORPUS_IMG}^2: {seen}")
    need(seen.get("roi_pool", [None])[0] == [TRAIN_B, u, u, 64],
         f"K1's map at {CORPUS_IMG}^2: {seen}")
    return seen


def phase_corpus(torch, dev, tmp):
    """Fold-1's protocol at the corpus clone's size, cut to prefixes of
    its lists: the clone generated by ``scripts/make_corpus_clone_torch.py``
    at 512^2, ``cli train -e 2`` at full width as a subprocess under
    ``COVA_RSS_LIMIT_GB=0.001`` (the watchdog re-execs it once after epoch
    1 and the new process resumes at epoch 2), then the kernels at these
    shapes."""
    import runpy

    import numpy as np

    from cova_tpu_torch.config import Config

    script = os.path.join(ROOT, "scripts", "make_corpus_clone_torch.py")
    splits, clone, out = (os.path.join(tmp, d)
                          for d in ("splits", "clone", "results"))
    ids = runpy.run_path(script)["fold_subset"](
        os.path.join(ROOT, "splits"), splits, 1, *CORPUS_SPLIT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, script, "--out", clone,
                        "--img_height", str(CORPUS_IMG), "--splits", splits],
                       capture_output=True, text=True, timeout=CORPUS_TIMEOUT)
    need(r.returncode == 0, f"clone generation failed:\n{r.stdout}{r.stderr}")
    clone_s = time.perf_counter() - t0
    need(len(os.listdir(os.path.join(clone, "imgs"))) == len(ids),
         "the clone lacks pages")

    counts = os.path.join(tmp, "launches.json")
    args = ["train", "--data_dir", clone, "--split_dir", splits, "-cvf", "1",
            "--img_height", str(CORPUS_IMG), "--output_dir", out,
            "--decode_cache", os.path.join(tmp, "decode_cache"), "-e", "2"]
    t0 = time.perf_counter()
    r = subprocess.run(rank_command(counts, args), cwd=ROOT,
                       env=dict(os.environ, COVA_RSS_LIMIT_GB="0.001"),
                       capture_output=True, text=True, timeout=CORPUS_TIMEOUT)
    train_s = time.perf_counter() - t0
    text = r.stdout + r.stderr
    need(r.returncode == 0,
         f"corpus train returned {r.returncode}:\n{text[-4000:]}")
    need(text.count("[rss-watchdog]") == 1 and "after epoch 1" in text,
         f"no single watchdog restart after epoch 1:\n{text[-4000:]}")
    need(text.count("Resuming from epoch 2") == 1, "no resume at epoch 2")
    epochs = re.findall(r"^Epoch:\s*(\d+)\s+Loss: ([\d.]+)", text, re.M)
    losses = [float(x) for _, x in epochs]
    need([e for e, _ in epochs] == ["1", "2"] and np.isfinite(losses).all(),
         f"epoch lines {epochs}")
    launches = {}
    for part, path in (("before_restart", counts + ".exec"),
                       ("after_restart", counts)):
        with open(path) as f:
            launches[part] = json.load(f)["launches"]
        need(all(launches[part][k] > 0 for k in TRAIN_KERNELS),
             f"a kernel was not launched {part}: {launches[part]}")
        need(not (launches[part]["conv3x3_fwd"]
                  or launches[part]["conv3x3_roll_fwd"]),
             f"a conv kernel launched with the opt-in off: {launches[part]}")
    res = os.path.join(out, Config(img_height=CORPUS_IMG).params_key)
    for name in ("Fold-1 logs.txt", "Fold-1 test_acc_imgwise.csv",
                 "Fold-1 test_acc_domainwise.csv", "fold_wise_acc.csv",
                 "metrics.jsonl", "Fold-1 saved_model.pt/best.pt",
                 "Fold-1 saved_model.pt/last.pt"):
        need(os.path.isfile(os.path.join(res, name)),
             f"the corpus train wrote no {name!r}")
    with open(os.path.join(res, "Fold-1 test_acc_imgwise.csv")) as f:
        n_test = len(f.readlines()) - 1
    need(n_test == CORPUS_SPLIT[2], f"imgwise CSV has {n_test} pages")
    test_line = [x for x in text.splitlines() if x.startswith("[TEST]")]
    return dict(
        pages=len(ids), split=list(CORPUS_SPLIT), img=CORPUS_IMG,
        clone_s=clone_s, train_wall_s=train_s, epoch_losses=losses,
        test=test_line, launches=launches,
        shapes=corpus_shapes(torch, dev, clone, ids),
        checks=corpus_kernels(torch, dev))


def phase_profile(torch, dev, tmp):
    """``cli train -e 1`` with ``COVA_PROFILE_DIR`` set: one trace, named
    for rank 0, that names K1, K3, K5 and K6 with device time."""
    import runpy

    from cova_tpu_torch import cli

    trace_dir = os.path.join(tmp, "trace")
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"COVA_PROFILE_DIR": trace_dir}):
        rc = cli.main(["train", "--synthetic", str(PROFILE_PAGES),
                       "--img_height", str(IMG), "-e", "1",
                       "--output_dir", os.path.join(tmp, "results")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(rc == 0, f"profiled train returned {rc}")
    files = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
    need(len(files) == 1 and files[0].startswith("rank0.")
         and files[0].endswith(".pt.trace.json.gz"),
         f"the hook wrote {files}, not one rank-0 trace")
    trace = runpy.run_path(os.path.join(ROOT, "scripts",
                                        "read_torch_trace.py"))["read_trace"](
        os.path.join(trace_dir, files[0]))
    seen = trace["port_kernels"]
    k1 = [k for k in ("roi_pool_pyramid_kernel", "roi_pool_bins_kernel")
          if k in seen]
    for name in k1[:1] + ["roi_pool_bwd_kernel", "bn_relu_pool_fwd_kernel",
                          "bn_relu_pool_bwd_kernel"]:
        need(seen.get(name, {}).get("ms", 0) > 0,
             f"the trace shows no device time of {name}: {seen}")
    need(bool(k1), f"the trace shows no K1 kernel: {seen}")
    for name, wrapper in (("roi_pool_bwd_kernel", "roi_pool_bwd"),
                          ("bn_relu_pool_bwd_kernel", "bn_relu_pool_bwd")):
        need(seen[name]["launches"] == launches[wrapper],
             f"{name}: {seen[name]['launches']} in the trace, "
             f"{launches[wrapper]} launched")
    return launches, dict(
        train_wall_s=wall, pages=PROFILE_PAGES, trace=files[0],
        trace_bytes=os.path.getsize(os.path.join(trace_dir, files[0])),
        steps=trace["steps"], window_ms=trace["window_ms"],
        device_busy_ms=trace["device_busy_ms"],
        idle_share=trace["idle_share"],
        device_ms_by_category=trace["device_ms_by_category"],
        port_kernels=seen)


# The graphs phase. (a): 8 train steps alternating two box buckets, the
# generator re-seeded after the 4th (an epoch boundary); (b): 3 replays of
# one train graph; (c): the eval and forward graphs at every bucket; (e):
# paired timings, GRAPH_REPS steps a side after the warm-up and capture.
GRAPH_STEPS, GRAPH_EPOCH = 8, 4
GRAPH_EAGER_RUNS = 5
GRAPH_TRAIN_P = (128, P)
GRAPH_REPLAYS = 3
GRAPH_REPS = 10
GRAPH_PROFILED = 3


def graph_train_batches(cfg):
    """GRAPH_STEPS train batches at B = 5 from the train pipeline, at P =
    128 and 232 in turns (the 128 ones cut to their first 128 boxes)."""
    from cova_tpu_torch.benchmarks import _first_boxes
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_pipelines
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset

    ds = InMemoryWebDataset(GRAPH_STEPS * TRAIN_B, IMG, seed=SEED + 3,
                            max_boxes=cfg.max_boxes)
    train_p, _, _ = make_pipelines(cfg, ds, ds, ds)
    out = []
    for i, (_, batch) in zip(range(GRAPH_STEPS), train_p.epoch(1)):
        batch = pad_batch(batch, TRAIN_B)[0]
        p = GRAPH_TRAIN_P[i % 2]
        out.append(batch if p == P else _first_boxes(batch, p))
    need(len(out) == GRAPH_STEPS, f"{len(out)} train batches, not "
                                  f"{GRAPH_STEPS}")
    return out


def graph_run(torch, cfg, dev, sd, batches, use_graphs, record=False,
              forced=None):
    """An (a) run: a state from ``sd``, one dropout generator re-seeded at
    each epoch of GRAPH_EPOCH steps, one step a batch. ``record``: keep a
    copy of the state and the generator's position before each step;
    ``forced``: such copies, put in place before each step (each step then
    starts where the recorded run's did). Returns the state, the generator,
    the losses, the launches counted from 0 and the copies."""
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import create_train_state, train_step
    from cova_tpu_torch.train.trainer import dropout_generator

    model = build_model(cfg, device=dev)
    model.load_state_dict(sd)
    state = create_train_state(model, cfg)
    gen = None
    zero_counts()
    losses, copies = [], []
    for i, batch in enumerate(batches):
        if i % GRAPH_EPOCH == 0:
            gen = dropout_generator(SEED, i // GRAPH_EPOCH + 1, dev,
                                    generator=gen)
        if forced is not None and i > 0:  # step 1 starts from sd already
            tensors, pos = forced[i]
            with torch.no_grad():
                for k, v in state_tensors(torch, state).items():
                    v.copy_(tensors[k])
            # A replay advances the generator as the eager step did, and
            # the re-seed at an epoch boundary puts it where it was.
            need(torch.equal(gen.get_state(), pos),
                 f"step {i + 1}: the generator is not where the recorded "
                 f"run's was")
        if record:
            copies.append(({k: v.detach().clone() for k, v in
                            state_tensors(torch, state).items()},
                           gen.get_state()))
        losses.append(train_step(state, batch, gen,
                                 graphs=use_graphs)["loss_sum"])
    torch.cuda.synchronize()
    return (state, gen, [float(x) for x in losses], launch_counts(),
            copies)


def state_tensors(torch, state):
    """Every tensor a train step changes in place: parameters, buffers and
    the optimizer's state, by name."""
    out = dict(state.model.state_dict())
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                out[f"adam.{names[id(p)]}.{k}"] = v
    return out


def device_events(prof):
    """A profile's kernels, copies and sets: the device side of annotated
    ranges, the port's among them, which spans them, is left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not re.fullmatch(r"[\w.]+#[\w.]+", e.name)
            and not e.name.startswith("cova_tpu_torch.")]


def device_busy(torch, fn, n):
    """``fn`` run ``n`` times under ``torch.profiler`` (CPU and CUDA):
    device busy ms a run (the union of the kernels', copies' and sets'
    intervals; the device side of annotated ranges, the port's among them,
    which spans them, is left out), device events a run, and the port's
    kernels by name with their launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # the union's length
        if b > end:
            busy_us += b - max(a, end)
            end = b
    port = {}
    for e in events:
        for k in ("roi_pool_pyramid_kernel", "roi_pool_bins_kernel",
                  "roi_pool_bwd_kernel", "bn_relu_pool_fwd_kernel",
                  "bn_relu_pool_bwd_kernel", "bn_act_kernel"):
            if k in e.name:
                port[k] = port.get(k, 0) + 1
    return dict(device_busy_ms=busy_us / 1e3 / n,
                device_events=len(events) / n, port_kernel_launches=port)


# Each wrapper's kernel that launches once per wrapper launch, by the name
# the trace gives it (K1 launches its pyramid kernel and then its bins
# kernel).
TRACED_WRAPPERS = {"roi_pool_bins_kernel": "roi_pool_fwd",
                   "bn_relu_pool_fwd_kernel": "bn_relu_pool_fwd",
                   "roi_pool_bwd_kernel": "roi_pool_bwd",
                   "bn_relu_pool_bwd_kernel": "bn_relu_pool_bwd",
                   "bn_act_kernel": "bn_act"}
FORWARD_WRAPPERS = ("roi_pool_fwd", "bn_relu_pool_fwd", "bn_act")
TRAIN_WRAPPERS = ("roi_pool_fwd", "bn_relu_pool_fwd", "roi_pool_bwd",
                  "bn_relu_pool_bwd")


def paired_times(torch, name, make, step, wrappers,
                 sides=(False, True, True, False)):
    """``step(ctx, use_graphs)`` timed on the host clock in the order
    eager, graph, graph, eager: each side on a fresh context from
    ``make()``, two warm-up calls (the first eager, the second the graph's
    capture), GRAPH_REPS timed calls ending in a synchronize, then
    GRAPH_PROFILED calls under the profiler, whose kernels in the trace
    must match the launch counters' additions over those calls. Returns
    each side's numbers."""
    rows = []
    for use in sides:
        ctx = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(ctx, use)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step(ctx, use)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        t0 = time.perf_counter()
        start.record()
        for _ in range(GRAPH_REPS):
            step(ctx, use)
        end.record()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / GRAPH_REPS * 1e3
        peaks = (torch.cuda.max_memory_allocated(),
                 torch.cuda.max_memory_reserved())
        before = launch_counts()
        busy = device_busy(torch, lambda: step(ctx, use), GRAPH_PROFILED)
        counted = {k: n - before[k] for k, n in launch_counts().items()}
        traced = busy["port_kernel_launches"]
        for kernel, wrapper in TRACED_WRAPPERS.items():
            need(traced.get(kernel, 0) == counted[wrapper],
                 f"{name} (graphs={use}): {kernel} {traced.get(kernel, 0)} "
                 f"times in the trace, {wrapper} counted {counted[wrapper]}")
        for wrapper in wrappers:
            need(counted[wrapper] > 0, f"{name} (graphs={use}): {wrapper} "
                                       f"not launched in the profiled calls")
        row = dict(graphs=use, ms_per_step=ms,
                   event_ms_per_step=start.elapsed_time(end) / GRAPH_REPS,
                   first_call_s=first_s, second_call_s=second_s,
                   peak_allocated_bytes=peaks[0],
                   peak_reserved_bytes=peaks[1],
                   launches_counted=counted, **busy)
        runner = ctx.get("graphs")
        if use and runner is not None:
            row["graphs_held"] = len(runner().graphs)
            row["capture_s"] = runner().capture_seconds()
        rows.append(row)
        del ctx
        torch.cuda.empty_cache()
    return rows


def phase_graphs(torch, dev):
    """The step graphs at full width: (a) eight train steps over two
    buckets across an epoch boundary, eager against graphs; (b) one train
    graph replayed from one state at three generator positions against the
    eager step at each; (c) the eval and forward graphs at every bucket and
    a padded partial batch against the eager steps, bit for bit; (d) the
    launch counters of (a) and (c) against the eager runs'; (e) paired
    timings of the train step (1280^2 B = 5 and 8, 512^2 B = 5) and the
    forward (B = 10 and 32), whose profiled calls launch K9 4 times a
    forward and never in a train step."""
    import numpy as np

    from cova_tpu_torch import benchmarks
    from cova_tpu_torch.benchmarks import _first_boxes
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import Batch, pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train import graphs as graphs_mod
    from cova_tpu_torch.train.steps import (
        create_train_state,
        eval_step,
        forward_step,
        train_step,
    )

    cfg = Config(img_height=IMG)
    out = {"register_generator_state": hasattr(
        torch.cuda.CUDAGraph, "register_generator_state")}
    need(out["register_generator_state"],
         "this PyTorch's CUDAGraph has no register_generator_state")

    # (a) and (b) run under deterministic algorithms: on the default path
    # the atomics of the GAT gathers' scatter-adds and of cuDNN's weight
    # gradients make two eager runs differ in their last bits, Adam
    # amplifies that from step to step, and their order differs between an
    # eager run and a replay, so that eight free steps through graphs fell
    # outside the eager runs' spread in two of six whole runs on the card.
    # A graph captured here holds the deterministic kernels: the switches
    # are part of its key.
    with deterministic_algorithms(torch) as nondeterministic:
        # (a) Eight steps from one state, eager (GRAPH_EAGER_RUNS times: the
        # card's run-to-run spread, which Adam amplifies from step to step) and
        # through graphs. Then the graphs again with each step started from the
        # first eager run's state and generator position before that step:
        # every loss the same bits.
        batches = graph_train_batches(cfg)
        sd = {k: v.clone() for k, v in random_state_dict(torch, cfg).items()}
        e = graph_run(torch, cfg, dev, sd, batches, False, record=True)
        g = graph_run(torch, cfg, dev, sd, batches, True)
        again = [graph_run(torch, cfg, dev, sd, batches, False)
                 for _ in range(GRAPH_EAGER_RUNS - 1)]
        need(g[2][0] == e[2][0], f"first train loss {g[2][0]!r} through the "
                                 f"graph, {e[2][0]!r} eager")
        loss_rows = []
        for i, (lg, le) in enumerate(zip(g[2], e[2])):
            runs_i = [le] + [a[2][i] for a in again]
            spread = max(runs_i) - min(runs_i)
            tol = max(GRAD_RTOL * abs(le), PAR_SPREAD_MARGIN * spread)
            loss_rows.append(dict(step=i + 1, graphs=lg, eager=runs_i,
                                  tol=tol))
            need(np.isfinite(lg) and abs(lg - le) <= tol,
                 f"step {i + 1}: loss {lg} through graphs, eager {runs_i} "
                 f"(tolerance {tol})")
        # Every parameter and BN buffer after the last step, within the
        # gradient rule or PAR_SPREAD_MARGIN times the farthest eager run's
        # distance; Adam's moments (which the runs from the eager states below
        # hold to the rule) reported.
        def model_tensors(run):
            return {k: v.float() for k, v in run[0].model.state_dict().items()}

        def adam_tensors(run):
            return {k: v.float()
                    for k, v in state_tensors(torch, run[0]).items()
                    if k.startswith("adam.")}

        tb = model_tensors(e)
        ta = model_tensors(g)
        need(set(ta) == set(tb), "the graphed model holds other tensors")
        vs_eager = grad_diff(ta, tb)
        spreads = [grad_diff(model_tensors(a), tb)["share_of_tolerance"]
                   for a in again]
        need(vs_eager["share_of_tolerance"] <= max(
            1.0, PAR_SPREAD_MARGIN * max(spreads)),
            f"model after {GRAPH_STEPS} steps: graphs against eager "
            f"{vs_eager}, eager against eager {spreads}")
        adam_e = adam_tensors(e)
        adam_vs = dict(graphs=grad_diff(adam_tensors(g), adam_e)[
            "share_of_tolerance"], eager=[grad_diff(adam_tensors(a), adam_e)[
                "share_of_tolerance"] for a in again])
        # Where the eager runs agree bit for bit (no op ran without a
        # deterministic kernel), the graphs' run must equal them: every
        # loss, parameter, buffer and Adam moment.
        exact = all(a[2] == e[2] for a in again) and all(
            all(torch.equal(model_tensors(a)[k], tb[k]) for k in tb)
            for a in again)
        if exact:
            adam_g = adam_tensors(g)
            need(g[2] == e[2] and all(torch.equal(ta[k], tb[k]) for k in tb)
                 and all(torch.equal(adam_g[k], v) for k, v in adam_e.items()),
                 f"the eager runs agree bit for bit, the graphs' does not: "
                 f"losses {g[2]} against {e[2]}, model {vs_eager}, Adam "
                 f"{adam_vs['graphs']}")
        del again, ta
        tb = {k: v.float() for k, v in state_tensors(torch, e[0]).items()}
        f = graph_run(torch, cfg, dev, sd, batches, True, forced=e[4])
        need(f[2] == e[2], f"steps from the eager run's states: losses {f[2]} "
                           f"through graphs, {e[2]} eager")
        forced_last = grad_diff({k: v.float() for k, v in state_tensors(
            torch, f[0]).items()}, tb)
        need(forced_last["share_of_tolerance"] <= 1.0,
             f"step {GRAPH_STEPS} from the eager run's state: {forced_last}")
        for run, name in ((g, "graphs"), (f, "graphs from eager states")):
            adam_steps = sorted({float(st["step"]) for st in
                                 run[0].optimizer.state.values()})
            need(adam_steps == [float(GRAPH_STEPS)]
                 and run[0].step == GRAPH_STEPS,
                 f"{name}: Adam's step counts {adam_steps}, state.step "
                 f"{run[0].step}")
        tracked = {r: sorted({int(v) for k, v in run[0].model.state_dict()
                              .items() if k.endswith("num_batches_tracked")})
                   for r, run in (("graphs", g), ("eager", e))}
        need(tracked["graphs"] == tracked["eager"] == [GRAPH_STEPS],
             f"num_batches_tracked {tracked}")
        # (d), train: the counters through replays equal the eager run's.
        need(g[3] == e[3] == f[3],
             f"launches through graphs {g[3]} and {f[3]}, eager {e[3]}")
        need(all(g[3][k] > 0 for k in TRAIN_KERNELS), f"launches {g[3]}")
        runner = g[0].graphs
        need(runner is not None and len(runner.graphs) == len(GRAPH_TRAIN_P),
             f"train graphs held: "
             f"{None if runner is None else len(runner.graphs)}")
        out["train"] = dict(
            steps=GRAPH_STEPS, epoch_boundary_after=GRAPH_EPOCH,
            p_buckets=[b.boxes.shape[1] for b in batches], losses=loss_rows,
            loss_bit_equal=[a == b for a, b in zip(g[2], e[2])],
            eager_runs_bit_equal=exact,
            model_vs_eager=vs_eager, model_eager_vs_eager_shares=spreads,
            adam_state_shares=adam_vs,
            from_eager_states=dict(losses_bit_equal=True,
                                   state_after_last_step=forced_last),
            adam_steps=GRAPH_STEPS, num_batches_tracked=tracked["graphs"],
            launches=g[3], launches_eager=e[3],
            capture_s=runner.capture_seconds())
        del f, tb
        g = g[:2]

        # (b) One train graph (P = 232) replayed from one state at three
        # generator positions, each against the eager step there.
        state, gen = g
        batch = batches[1]
        saved = {k: v.detach().clone()
                 for k, v in state_tensors(torch, state).items()}

        def put_back():
            with torch.no_grad():
                for k, v in state_tensors(torch, state).items():
                    v.copy_(saved[k])
            state.step = GRAPH_STEPS

        replays = []
        for r in range(GRAPH_REPLAYS):
            put_back()
            pos = gen.get_state()
            lg = float(train_step(state, batch, gen)["loss_sum"])
            after = gen.get_state()
            put_back()
            gen.set_state(pos)
            le = float(train_step(state, batch, gen, graphs=False)["loss_sum"])
            need(torch.equal(gen.get_state(), after),
                 f"replay {r}: the eager step left the generator elsewhere")
            need(lg == le, f"replay {r}: loss {lg!r} through the graph, "
                           f"{le!r} eager from the same state and generator "
                           f"position")
            replays.append(dict(replay=r, loss=lg, eager=le))
        need(len({x["loss"] for x in replays}) == GRAPH_REPLAYS,
             f"the replays drew one mask: {replays}")
        need(len(state.graphs.graphs) == len(GRAPH_TRAIN_P),
             "the replays captured again")
        out["dropout"] = replays
        del e, g, state, saved
        torch.cuda.empty_cache()
    out["train"]["nondeterministic_ops"] = nondeterministic

    # (c) Eval and forward at every bucket, at B = 10 and for a padded
    # partial batch, through graphs against eager, bit for bit; (d) the
    # counters of the graphed calls against the same calls eagerly.
    model = build_model(cfg, device=dev)
    model.load_state_dict(random_state_dict(torch, cfg))
    ds = InMemoryWebDataset(2 * B, IMG, seed=SEED + 4,
                            max_boxes=cfg.max_boxes)
    it = iter(make_eval_pipeline(cfg, ds).epoch(0))
    full = pad_batch(next(it)[1], B)[0]
    part = next(it)[1]
    part = pad_batch(Batch(*[x[:3] for x in part]), B)[0]
    calls = []
    for p in CORPUS_BUCKETS:
        cut = (lambda x: x) if p == P else (lambda x, p=p: _first_boxes(x, p))
        calls += [cut(full), cut(full), cut(part)]

    def serve(use):
        zero_counts()
        got = []
        for batch in calls:
            ev = eval_step(model, batch, graphs=use)
            fw = forward_step(model, batch, graphs=use)
            got.append((ev["correct"], ev["present"], ev["logits"],
                        fw.logits, fw.attn_wts))
        torch.cuda.synchronize()
        return got, launch_counts()

    want, n_eager = serve(False)
    got, n_graphs = serve(True)
    for i, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip(("correct", "present", "eval logits",
                               "logits", "attention"), a, b):
            need(torch.equal(x, y), f"call {i} (P = {x.shape[1]}): {name} "
                                    f"through the graph differ from eager")
    need(n_graphs == n_eager, f"serving launches through graphs "
                              f"{n_graphs}, eager {n_eager}")
    held = graphs_mod.model_graphs(model)
    need(len(held.graphs) == 2 * len(CORPUS_BUCKETS),
         f"{len(held.graphs)} eval and forward graphs held")
    out["serve"] = dict(p_buckets=list(CORPUS_BUCKETS), batch=B,
                        partial_pages=3, calls=2 * len(calls),
                        launches=n_graphs, launches_eager=n_eager,
                        graphs_held=len(held.graphs),
                        capture_s=held.capture_seconds())
    del model, held, got, want
    torch.cuda.empty_cache()

    # (e) Paired timings.
    def train_ctx(c, batch):
        def make():
            state = create_train_state(build_model(c, device=dev), c)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            return dict(state=state, gen=gen, batch=batch,
                        graphs=lambda: state.graphs)
        return make

    def train_call(ctx, use):
        train_step(ctx["state"], ctx["batch"], ctx["gen"], graphs=use)

    def fwd_ctx(c, batch):
        def make():
            model = build_model(c, device=dev)
            return dict(model=model, batch=batch,
                        graphs=lambda: graphs_mod.model_graphs(model))
        return make

    def fwd_call(ctx, use):
        forward_step(ctx["model"], ctx["batch"], graphs=use)

    def staged(batch):
        return benchmarks.stage_batch(batch, dev)

    c512 = Config(img_height=CORPUS_IMG)
    ds512 = InMemoryWebDataset(TRAIN_B, CORPUS_IMG, seed=SEED,
                               max_boxes=c512.max_boxes)
    b512 = pad_batch(next(iter(make_eval_pipeline(
        c512.replace(eval_batch_size=TRAIN_B), ds512).epoch(0)))[1],
        TRAIN_B)[0]
    bench8 = benchmarks.bench_config(BENCH_TRAIN_B, IMG, "bfloat16", False)
    bench32 = benchmarks.bench_config(BENCH_INFER_B, IMG, "bfloat16", False)
    timing = {}
    train, fwd = (train_call, TRAIN_WRAPPERS), (fwd_call, FORWARD_WRAPPERS)
    for name, make, (call, launched) in (
        ("train_1280_b5", train_ctx(cfg, staged(batches[1])), train),
        ("train_1280_b8", train_ctx(bench8, staged(benchmarks.bench_batch(
            bench8, benchmarks.TRAIN_SEED))), train),
        ("train_512_b5", train_ctx(c512, staged(b512)), train),
        ("forward_1280_b10", fwd_ctx(cfg, staged(full)), fwd),
        # The serve phase's batch as it comes: host arrays, pinned and
        # copied at every call.
        ("forward_1280_b10_host", fwd_ctx(cfg, full), fwd),
        ("forward_1280_b32", fwd_ctx(bench32, staged(benchmarks.bench_batch(
            bench32, benchmarks.INFER_SEED))), fwd),
    ):
        timing[name] = paired_times(torch, name, make, call, launched)
        # Every config here has the default trunk; a train step never
        # launches K9.
        k9 = BN_ACT_PER_BATCH[cfg.backbone] if launched is FORWARD_WRAPPERS \
            else 0
        for row in timing[name]:
            got = row["launches_counted"]["bn_act"] / GRAPH_PROFILED
            need(got == k9, f"{name} (graphs={row['graphs']}): K9 launched "
                            f"{got} times a step, expected {k9}")
    out["timing"] = timing
    out["timing_order"] = "eager, graphs, graphs, eager"
    return out


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
    """The first forward's output (eager) and ms per forward over ``reps``
    after it and the capture of the batch's graph."""
    from cova_tpu_torch.train.steps import forward_step

    out = forward_step(model, batch)
    forward_step(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        forward_step(model, batch)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def timed_steps(torch, cfg, dev, batch, sd=None, reps=10, warmup=2):
    """ms per train step (Adam included) on a fixed batch from the seeded
    init (or ``sd``), the first and the last loss, peak memory over all the
    steps, and the number of steps taken. The warm-up takes at least
    two steps, so that the graph's capture (the second) is not timed."""
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import create_train_state, train_step

    state = create_train_state(build_model(cfg, device=dev), cfg)
    if sd is not None:
        state.model.load_state_dict(sd)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    warmup = max(warmup, 2)
    # From the first step on: a replay allocates only its copies, the
    # step's own peak falls in the eager step and the capture.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(train_step(state, batch, gen)["loss_sum"])
              for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        m = train_step(state, batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    return dict(ms_per_step=ms, first_loss=losses[0],
                last_loss=float(m["loss_sum"]),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                steps=warmup + reps)


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
    forward_step(model, batch, graphs=False)  # a replay runs no hook
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
            plain = forward_step(model, batch, graphs=False)
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
                per_step = ((launch_counts()["conv3x3_fwd"] - before)
                            // row["step_opt_in"]["steps"])
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
          "bn_act": ptxas_report(reports.get("bn_act", ""),
                                 ("bn_act_kernel",)),
          "layernorm": ptxas_report(reports.get("layernorm", ""),
                                    ("swin_layernorm_kernel",)),
          "sass": sass_report(_build, {
              "bn_pool": "bn_relu_pool_fwd_kernel",
              "roi_pool": "roi_pool_bwd_kernel"})})

    # Phase names as arguments run those phases alone (for work on one of
    # them); the summary and the ok line come only from a whole run.
    phases = ("kernels", "bn_act", "window_attn", "layernorm",
              "conv_kernels", "serve",
              "train", "bench", "export", "visualize", "sweep", "parallel",
              "corpus", "profile", "graphs", "conv", "backbones")
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
    if wanted("bn_act"):
        seconds()
        k9_results, k9_launches = phase_bn_act(torch, dev)
        emit({"phase": "bn_act", "seconds": seconds(),
              "results": k9_results,
              "launches_per_serving_batch": k9_launches})
    if wanted("window_attn"):
        seconds()
        k10_results, k10_launches = phase_window_attn(torch, dev)
        emit({"phase": "window_attn", "seconds": seconds(),
              "results": k10_results,
              "launches_per_serving_batch": k10_launches})
    if wanted("layernorm"):
        seconds()
        k11_results, k11_launches = phase_layernorm(torch, dev)
        emit({"phase": "layernorm", "seconds": seconds(),
              "results": k11_results, "nvidia_smi": smi,
              "serving_batch": k11_launches})
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
    if wanted("corpus"):
        seconds()
        with tempfile.TemporaryDirectory() as tmp:
            emit({"phase": "corpus", **phase_corpus(torch, dev, tmp),
                  "seconds": seconds()})
    if wanted("profile"):
        seconds()
        with tempfile.TemporaryDirectory() as tmp:
            profile_launches, profile = phase_profile(torch, dev, tmp)
        emit({"phase": "profile", "seconds": seconds(),
              "launches": profile_launches, **profile})
    if wanted("graphs"):
        seconds()
        emit({"phase": "graphs", **phase_graphs(torch, dev),
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
