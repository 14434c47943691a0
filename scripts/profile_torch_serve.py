#!/usr/bin/env python3
"""Where the time of one flagship serving batch, or one train step, of the
PyTorch port goes.

    python3 scripts/profile_torch_serve.py          # serving, on a GPU
    python3 scripts/profile_torch_serve.py --train  # one train step
    ... --train --prefetch   # batches through data.device_prefetch
    ... [--train] --conv     # with COVA_CUDA_CONV=1 (the hand-written conv)
    ... [--train] --bench    # the batch of `cli bench` (infer / train mode)
    ... --train --stack NAME # which op of the model launches kernel NAME
    ... [--train] --graphs   # the steps through their CUDA graphs

Builds the flagship model (resnet18_stem, 1280^2, P = 232, -cs 12, -hd 384,
bf16). Serving: the seeded random weights of ``chip_smoke.py`` and one batch
of B = 10 synthetic pages, tracing ``forward_step`` (host copy included) over
10 batches. Train: the model as ``build_model`` initialises it and
``chip_smoke.py``'s fixed train batch (B = 5, BG subsampled), tracing
``train_step`` (host copy, forward, backward and the Adam update) over 10
steps; with ``--prefetch`` the step takes its batch from the device
prefetcher, as the trainer does, instead of pinning and copying it itself.
With ``--bench`` the batch is the bench's (``benchmarks.bench_batch``:
B = 32 serving, B = 8 training, P bucketed to 128), staged on the device
once as the bench stages it, and the weights are ``build_model``'s.
Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
window's wall time per batch, the device's
busy time (union of kernel and copy intervals), its idle share, device time
by category, the top kernels, the top aten ops with their input shapes, and
the host ops with the most self CPU time.

The steps run eagerly (``graphs=False``) unless ``--graphs`` is given: a
CUDA graph's replay has no host ops of its own, only its kernels, and the
warm-up's second step captures it. With ``--stack NAME`` the trace
also records shapes and Python stacks, and the line adds, for every device
kernel whose name holds NAME, the host op that launched it, the autograd
node above it, and the forward op of that node (matched by its sequence
number) with its input shapes and Python stack: the model's line that the
kernel serves.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATEGORIES = (  # first match wins
    ("roi_pool (K1)", ("roi_pool_pyramid", "roi_pool_bins")),
    ("roi_pool bin bounds (K3)", ("roi_pool_bounds",)),
    ("bn_relu_pool (K5)", ("bn_relu_pool_fwd",)),
    ("roi_pool backward (K3)", ("roi_pool_bwd",)),
    ("bn_relu_pool backward (K6)", ("bn_relu_pool_bwd",)),
    ("bn_act (K9)", ("bn_act_kernel",)),
    ("conv3x3_roll (K8)", ("conv3x3_roll_fwd",)),
    ("conv3x3 (K7)", ("conv3x3_fwd",)),
    ("convolution", ("conv", "cudnn", "implicit", "xmma", "fprop", "dgrad",
                     "wgrad")),
    ("matmul", ("gemm", "cutlass", "cublas", "splitk")),
    ("optimizer (Adam)", ("multi_tensor_apply", "adam")),
    ("copy", ("memcpy", "memset")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise / other"


def union(spans):
    """The (start, end) intervals ``spans`` merged into disjoint ones, in
    order: the device's busy time is their total length."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def kernel_sources(events, name: str) -> list:
    """For each host op that launched a kernel whose name holds ``name``:
    the op, the autograd node above it (in the backward), and the forward
    op of that node (the same sequence number, on the forward's thread),
    each with input shapes; the forward op with its Python stack. One entry
    per distinct chain, with its launch count."""
    cpu = [e for e in events if getattr(e, "kernels", None)]
    fwd = {}
    for e in events:
        seq = getattr(e, "sequence_nr", -1)
        if seq >= 0 and e.name.startswith("aten::"):
            fwd.setdefault(seq, e)

    def python_stack(e):
        """The port's Python frames of ``e``, innermost first: its
        ``stack`` (file and line), or where the trace holds the frames as
        parent events instead, those (file and the function's first
        line)."""
        frames = list(e.stack or [])
        if not frames:
            p = e.cpu_parent
            while p is not None:
                frames.append(p.name)
                p = p.cpu_parent
        return [f for f in frames if "cova_tpu_torch/" in f]
    chains = {}
    for e in cpu:
        n = sum(1 for k in e.kernels if name in k.name)
        if not n:
            continue
        node = e
        while node is not None and not node.name.endswith("Backward0") \
                and "Backward" not in node.name:
            node = node.cpu_parent
        seq = getattr(node, "sequence_nr", -1) if node is not None else -1
        f = fwd.get(seq)
        key = (e.name, str(e.input_shapes), node.name if node else None,
               f.name if f else None)
        entry = chains.setdefault(key, {
            "op": e.name, "op_shapes": str(e.input_shapes)[:160],
            "autograd_node": node.name if node else None,
            "forward_op": f.name if f else None,
            "forward_shapes": str(f.input_shapes)[:160] if f else None,
            "forward_stack": python_stack(f)[:6] if f else [],
            "launches": 0})
        entry["launches"] += n
    return list(chains.values())


def main() -> int:
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("profile_torch_serve: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    train = "--train" in sys.argv[1:]
    graphs = "--graphs" in sys.argv[1:]
    stack = (sys.argv[sys.argv.index("--stack") + 1]
             if "--stack" in sys.argv[1:] else None)
    prefetch = "--prefetch" in sys.argv[1:]
    bench = "--bench" in sys.argv[1:]
    if "--conv" in sys.argv[1:]:
        os.environ["COVA_CUDA_CONV"] = "1"
    sys.path.insert(0, ROOT)
    import chip_smoke
    from cova_tpu_torch import benchmarks
    from cova_tpu_torch.config import Config
    from cova_tpu_torch.data.batching import pad_batch
    from cova_tpu_torch.data.pipeline import make_eval_pipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset
    from cova_tpu_torch.models.cova import build_model
    from cova_tpu_torch.train.steps import (
        create_train_state,
        forward_step,
        train_step,
    )

    dev = torch.device("cuda")
    cfg = Config(img_height=chip_smoke.IMG)
    if bench:
        b = chip_smoke.BENCH_TRAIN_B if train else chip_smoke.BENCH_INFER_B
        cfg = benchmarks.bench_config(b, chip_smoke.IMG, "bfloat16", False)
        seed = benchmarks.TRAIN_SEED if train else benchmarks.INFER_SEED
        batch = benchmarks.bench_batch(cfg, seed)
        if not prefetch:  # staged once, as the bench stages it
            batch = benchmarks.stage_batch(batch, dev)
    if train:
        if not bench:
            b = chip_smoke.TRAIN_B
            batch = chip_smoke.fixed_train_batch(cfg)
        state = create_train_state(build_model(cfg, device=dev), cfg)
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)

        if prefetch:
            import itertools

            from cova_tpu_torch.data.device_prefetch import device_prefetch

            fed = device_prefetch(itertools.repeat((None, batch)), dev)

            def run():
                train_step(state, next(fed)[2], gen, graphs=graphs)
        else:
            def run():
                train_step(state, batch, gen, graphs=graphs)
    elif bench:
        model = build_model(cfg, device=dev)
    else:
        b = chip_smoke.B
        model = build_model(cfg, device="cpu")
        model.load_state_dict(chip_smoke.random_state_dict(torch, cfg))
        model = model.to(dev)
        ds = InMemoryWebDataset(b, chip_smoke.IMG, seed=chip_smoke.SEED,
                                max_boxes=cfg.max_boxes)
        _, batch = next(iter(make_eval_pipeline(cfg, ds).epoch(0)))
        batch, _ = pad_batch(batch, b)
    if not train:

        def run():
            forward_step(model, batch, graphs=graphs)
    for _ in range(3):  # warm-up: kernel build, cuDNN plans, allocator
        run()
    torch.cuda.synchronize()

    reps = 10
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True,
                                with_stack=stack is not None) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device kernels and copies; user-annotation ranges (such as
    # "Optimizer.step#Adam.step") span other events and are left out.
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not re.fullmatch(r"[\w.]+#[\w.]+", e.name)]
    if not events:
        print("profile_torch_serve: the trace holds no device events",
              file=sys.stderr)
        return 1
    busy_us = sum(e - s for s, e in union(
        (e.time_range.start, e.time_range.end) for e in events))
    by_cat, by_name = {}, {}
    for e in events:
        us = e.time_range.elapsed_us()
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # Device time of each aten op (with its input shapes), for the kernels
    # PyTorch launches itself: which op a copy or elementwise pass is.
    ops = sorted(
        (a for a in prof.key_averages(group_by_input_shape=True)
         if a.key.startswith("aten::") and a.self_device_time_total > 0),
        key=lambda a: -a.self_device_time_total,
    )[:12]
    # Where the host's time goes: the ops with the most self CPU time.
    host = sorted(
        (a for a in prof.key_averages() if a.self_cpu_time_total > 0),
        key=lambda a: -a.self_cpu_time_total,
    )[:12]
    launched_by = kernel_sources(prof.events(), stack) if stack else None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi[0] if smi else None,
        "mode": "train_step" if train else "serve",
        "prefetch": prefetch, "bench_batch": bench, "graphs": graphs,
        "cuda_conv": os.environ.get("COVA_CUDA_CONV") == "1",
        "batch": b, "P": int(batch.boxes.shape[1]), "reps": reps,
        "wall_ms_per_batch": wall_ms / reps,
        "device_busy_ms_per_batch": busy_us / 1e3 / reps,
        "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_ms_per_batch_by_category": {
            k: v / 1e3 / reps for k, v in sorted(by_cat.items(),
                                                 key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": [[n[:90], v / 1e3 / reps]
                                     for n, v in top],
        "top_aten_ops_ms_per_batch": [
            [a.key, str(a.input_shapes)[:120],
             a.self_device_time_total / 1e3 / reps] for a in ops],
        "top_host_ops_self_ms_per_batch": [
            [a.key, a.self_cpu_time_total / 1e3 / reps] for a in host],
        **({"stack": stack, "launched_by": launched_by} if stack else {}),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
