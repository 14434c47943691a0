#!/usr/bin/env python3
"""The port's ``cli bench`` on one GPU, in turns, every result printed.

    python3 scripts/bench_port.py [--rounds 2] [--out FILE.jsonl]

Each round runs ``cova_tpu_torch.cli bench`` in this process at the
flagship widths (1280^2, bf16): train (B = 8) and infer (B = 32) with
``COVA_CUDA_CONV`` off and on, in the order off, on in even rounds and on,
off in odd ones, then e2e (in-memory pages, its defaults: 64 pages, three
timed epochs after a warm one). The opt-in is read at each conv call, so
one process can take both sides. Every line carries the card's name and
power limit from ``nvidia-smi``; the last line holds, per configuration,
every reading and its spread (max - min).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench(flags, conv: bool):
    """One ``cli bench`` run with the conv opt-in set as asked: its JSON
    result."""
    from cova_tpu_torch import cli

    os.environ["COVA_CUDA_CONV"] = "1" if conv else "0"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", *flags])
    if rc != 0:
        raise SystemExit(f"bench {flags} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


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
        for mode, flags in (("train", ["-bsb", "8"]),
                            ("infer", ["-bsb", "32"])):
            for conv in order:
                res = bench(["--mode", mode, *flags], conv)
                key = f"{mode} conv_opt_in={int(conv)}"
                runs.setdefault(key, []).append(res)
                emit({"round": r, "config": key, "nvidia_smi": smi, **res})
        res = bench(["--mode", "e2e", "--e2e_source", "mem"], False)
        runs.setdefault("e2e conv_opt_in=0", []).append(res)
        emit({"round": r, "config": "e2e conv_opt_in=0",
              "nvidia_smi": smi, **res})
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
