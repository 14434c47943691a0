"""Run one cell of the benchmark of ``cova_tpu_torch`` once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for. Prints the check's numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
``card`` (the power limit), with ``--trace 1`` a ``breakdown``, and last
``checks``. Exits non-zero without a result where CUDA or the cards are
missing, or where the process has loaded JAX or the JAX package.

The port runs as its users run it: one process with PyTorch's default
number of intra-op threads.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "cova_tpu")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``
    (compared whole: ``cova_tpu_torch`` is not ``cova_tpu``)."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import manifest

    bench = manifest.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 3
    from benchmark import harness

    result, lines, _ = harness.run_cell(
        cell, bench.config(cell["config"]), bench.traffic(cell["traffic"]),
        bench.limits(cell["name"]), args.seed, args.seconds,
        bool(args.trace), "cuda", T_START, bench.metrics(),
        bench.readers(cell["name"]) if args.trace else None)
    bad = forbidden_modules(sys.modules)
    if bad:
        print("loaded modules that the benchmark must not load: "
              + ", ".join(bad), file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["card"] = {"name_and_power_limit": power_limit()}
    result["checks"] = checks
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
