"""The readings that the correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload NAME --seeds S1 S2 ... \
        [--seconds 2] [--out FILE]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(set-up, a short window, the check against the plain reference), whose
numbers are the program's readings; then the control, the reference
computed with float8 operands (``quant="fp8"``) in the program's place,
against the float32 reference on the same pages and weights. Prints one
JSON line a seed and a summary: for each number the largest program
reading and the smallest control reading.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import check, harness, manifest, pages, weights
    from benchmark.reference import cova as reference

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    bench = manifest.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])
    dev = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, _, numbers = harness.run_cell(
            cell, cfg, traffic, limits, seed, args.seconds, False, dev,
            t0, bench.metrics())
        row = {"seed": seed, "correct": result["correct"],
               "program": {k: numbers[k] for k in limits},
               "metrics": {k: v["value"] for k, v in
                           result["metrics"].items()}}
        pool = pages.make_pool(traffic, cfg, seed, dev)
        w = weights.make_weights(cfg, seed, dev)
        nb = len(pool.batches)
        all_pages = [pool.batch_pages(j) for j in range(nb)]
        valid = [[len(p["labels"]) for p in b] for b in all_pages]
        ref = reference.serve(w, all_pages, cfg, dev)
        ctl = reference.serve(w, all_pages, cfg, dev, quant="fp8")
        c = check.serve_numbers(list(enumerate(ctl)), ref, valid)
        row["control"] = {k: c[k] for k in ("logit_err", "logit_rel")}
        row["program"].update(
            {k: numbers[k] for k in ("logit_err", "logit_rel")})
        del pool, w
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for k in rows[0]["control"]:
        summary[k] = {
            "program_max": max(r["program"][k] for r in rows),
            "program_all": [r["program"][k] for r in rows],
            "control_min": min(r["control"][k] for r in rows)}
        vals = [r["program"][k] for r in rows]
        summary[k]["program_median"] = sorted(vals)[len(vals) // 2]
        if not all(math.isfinite(v) for v in vals):
            summary[k]["not_finite"] = True
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"rows": rows, "summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
