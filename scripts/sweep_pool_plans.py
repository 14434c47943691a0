#!/usr/bin/env python3
"""Time the stem pool forward (K5, ``ops/bn_pool.py:fwd_plan``) and the
RoIPool backward (K3, ``ops/roi_pool.py:roi_bwd_plan``) kernels over
variants of their launch plans, on one NVIDIA GPU.

    python3 scripts/sweep_pool_plans.py            # both kernels
    python3 scripts/sweep_pool_plans.py k5         # or k3

K5 runs at the serving batch (ys [10, 320, 320, 256]), K3 at the train batch
(fm [5, 320, 320, 64], P = 232 boxes of ``chip_smoke.py``'s synthetic
pages, on tied inputs), each in bf16 and f32. Every variant is first held
bit for bit against the plain version, then timed (CUDA events, the median
of three runs of 20 launches). Prints one JSON line per variant and, last,
the card (``nvidia-smi`` name and power limit) and the fastest variant of
each kernel and dtype. A variant the plan refuses (no room in shared
memory, too many threads) is reported as refused.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def median_ms(torch, fn, reps=20, runs=3):
    import chip_smoke

    return sorted(chip_smoke.cuda_ms(torch, fn, reps, warmup=2)
                  for _ in range(runs))[runs // 2]


def sweep_k5(torch, dev, emit):
    from cova_tpu_torch.ops import bn_pool

    gen = torch.Generator(device=dev).manual_seed(123)
    scale = torch.rand(64, generator=gen, device=dev) + 0.5
    shift = torch.randn(64, generator=gen, device=dev)
    best = {}
    for dtype in (torch.bfloat16, torch.float32):
        ys = torch.randn(10, 320, 320, 256, generator=gen, device=dev).to(
            dtype)
        want = bn_pool.bn_relu_pool_s2d_reference(ys, scale, shift)
        for stages, chunk_bytes, per_sm in itertools.product(
                (2, 3, 4), (32, 64, 128), (1, 2, 3, 4)):
            knobs = dict(stages=stages, chunk_bytes=chunk_bytes,
                         blocks_per_sm=per_sm)
            try:
                plan = bn_pool.fwd_plan(dtype, 10, 320, 320, 64, **knobs)
            except ValueError:
                emit(dict(kernel="K5", dtype=str(dtype), **knobs,
                          refused=True))
                continue
            got = bn_pool._forward(ys, scale, shift, plan)
            torch.cuda.synchronize()
            exact = torch.equal(got, want)
            ms = median_ms(torch, lambda: bn_pool._forward(ys, scale, shift,
                                                           plan))
            row = dict(kernel="K5", dtype=str(dtype), **knobs, exact=exact,
                       ms=ms, plan=plan._asdict())
            emit(row)
            if exact and ms < best.get(str(dtype), {}).get("ms", 1e9):
                best[str(dtype)] = row
        del ys, want
    return best


def sweep_k3(torch, dev, emit):
    import chip_smoke
    from cova_tpu_torch.ops import roi_pool

    gen = torch.Generator(device=dev).manual_seed(123)
    boxes, mask = chip_smoke.synthetic_boxes(torch, dev, 5)
    best = {}
    for dtype in (torch.bfloat16, torch.float32):
        fm = chip_smoke.tied(torch, gen, (5, 320, 320, 64), dtype, dev, 2.0)
        pooled = roi_pool.roi_pool_reference(fm, boxes, mask, 0.25)
        g = torch.randn(pooled.shape, generator=gen, device=dev).to(dtype)
        args = (fm, boxes, mask, pooled, g, 0.25)
        want = roi_pool.roi_pool_backward_reference(*args)
        for cap, chunk, per_sm in itertools.product(
                (256, 512), (16, 32, 64), (2, 3, 4, 6, 8)):
            knobs = dict(cap=cap, chunk=chunk, blocks_per_sm=per_sm)
            try:
                plan = roi_pool.roi_bwd_plan(
                    dtype, 5, boxes.shape[1], 320, 320, 64, 3, 3, cap=cap,
                    chunk=chunk, blocks_per_sm=per_sm)
            except ValueError:
                emit(dict(kernel="K3", dtype=str(dtype), **knobs,
                          refused=True))
                continue
            got = roi_pool.roi_pool_backward(*args, plan=plan)
            torch.cuda.synchronize()
            exact = torch.equal(got, want)
            ms = median_ms(torch, lambda: roi_pool.roi_pool_backward(
                *args, plan=plan))
            row = dict(kernel="K3", dtype=str(dtype), **knobs, exact=exact,
                       ms=ms, plan=plan._asdict())
            emit(row)
            if exact and ms < best.get(str(dtype), {}).get("ms", 1e9):
                best[str(dtype)] = row
        del fm, pooled, g, want, args
    return best


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_pool_plans: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from cova_tpu_torch.ops import _build

    _build.build(("bn_pool", "roi_pool"))
    dev = torch.device("cuda")
    which = sys.argv[1:] or ["k5", "k3"]

    def emit(obj):
        print(json.dumps(obj), flush=True)

    best = {}
    if "k5" in which:
        best["K5"] = sweep_k5(torch, dev, emit)
    if "k3" in which:
        best["K3"] = sweep_k3(torch, dev, emit)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi, "best": best})
    return 0


if __name__ == "__main__":
    sys.exit(main())
