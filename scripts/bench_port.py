#!/usr/bin/env python3
"""The port's benches on one GPU, eager and through CUDA graphs in turns,
every result printed.

    python3 scripts/bench_port.py [--rounds 2] [--out FILE.jsonl]

Each round runs ``cova_tpu_torch.benchmarks`` in this process at the
flagship widths (1280^2, bf16): train (B = 8), infer (B = 32) and e2e
(in-memory pages, its defaults: 64 pages, three timed epochs after a warm
one), each with its steps eager (``graphs=False``) and through their CUDA
graphs (``graphs=True``, the default), in the order eager, graphs in even
rounds and graphs, eager in odd ones. Each line also holds the peak
device memory of its run, allocated and reserved (with graphs: every
graph's private pool; e2e warms every box bucket). Every line carries the
card's name and power limit from ``nvidia-smi``; the last line holds, per
configuration, every reading and its spread (max - min).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench(mode: str, graphs: bool) -> dict:
    """One bench, its steps through graphs or eager."""
    from cova_tpu_torch import benchmarks

    if mode == "e2e":
        return benchmarks.run_e2e_bench(batch_size=8, source="mem",
                                        graphs=graphs)
    if mode == "infer":
        return benchmarks.run_infer_bench(batch_size=32, graphs=graphs)
    return benchmarks.run_train_bench(batch_size=8, graphs=graphs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="also append every line to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_port: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    runs = {}
    for r in range(args.rounds):
        order = (False, True) if r % 2 == 0 else (True, False)
        for mode in ("train", "infer", "e2e"):
            for graphs in order:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                res = bench(mode, graphs)
                res["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
                res["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
                key = f"{mode} graphs={int(graphs)}"
                runs.setdefault(key, []).append(res)
                emit({"round": r, "config": key, "nvidia_smi": smi, **res})
    summary = {}
    for key, rs in runs.items():
        vals = [x["value"] for x in rs]
        ms = [x.get("step_ms", x.get("epoch_seconds")) for x in rs]
        summary[key] = dict(pages_per_s=vals, spread=max(vals) - min(vals),
                            ms_or_epoch_s=ms)
    emit({"summary": summary, "nvidia_smi": smi, "rounds": args.rounds})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
