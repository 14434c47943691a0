#!/usr/bin/env python3
"""Where the RoIPool backward kernel (K3, ``csrc/roi_pool.cu``) spends its
time, on one NVIDIA GPU: the kernel as it is, and copies of it with one
stage left out, at the train batch (fm [5, 320, 320, 64], P = 232 boxes of
``chip_smoke.py``'s synthetic pages, tied inputs), bf16 and f32.

    python3 scripts/ablate_roi_bwd.py

Variants (each a text edit of the source, built by ``nvcc`` beside the
port's own libraries; the script fails if an edit no longer applies):

* ``full``: the kernel as committed;
* ``no_compare_add``: the walk skips every listed pair (lists built and
  rows staged, fm read and dfm written);
* ``no_staging``: the pooled and g rows are not copied (the walk reads
  stale shared memory);
* ``no_lists``: no candidate is tested, so no list is built or walked (fm
  read, the boxes scanned, dfm written);
* ``no_box_scan``: no box is scanned either (fm read, dfm written).

Every variant but ``full`` computes a wrong dfm: only their times mean
anything. Prints one JSON line per dtype (median of three runs of 20
launches each, CUDA events, ms) and the card (``nvidia-smi`` name and power
limit).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EDITS = {
    "full": [],
    "no_compare_add": [("          if (active) {\n            for (int q = q0;",
                        "          if (false) {\n            for (int q = q0;")],
    "no_staging": [("            cp_async<kUnit>(buf",
                    "            if (false) cp_async<kUnit>(buf")],
    "no_lists": [("    const int n_cand = n_box * bins;",
                  "    const int n_cand = 0 * n_box;")],
    "no_box_scan": [("    const int n_cand = n_box * bins;",
                     "    const int n_cand = 0 * n_box;"),
                    ("    for (int base = 0; base < P; base += nt) {",
                     "    for (int base = P; base < P; base += nt) {")],
}


def build(build_mod):
    """One library per variant under the build directory, all compiled at
    once; returns {variant: path}."""
    src = open(os.path.join(build_mod.CSRC, "roi_pool.cu")).read()
    out_dir = os.path.join(build_mod.BUILD_DIR, "ablate_roi_bwd")
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = {}, {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ablate_roi_bwd: edit of {name} does not "
                                   f"apply: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = subprocess.Popen(
            [build_mod._nvcc(), *build_mod.NVCC_FLAGS,
             f"-I{build_mod.CSRC}", "-o", libs[name], cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablate_roi_bwd: nvcc {name}:\n{log}")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_roi_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from cova_tpu_torch.ops import _build, roi_pool

    libs = build(_build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(123)
    boxes, mask = chip_smoke.synthetic_boxes(torch, dev, 5)
    for dtype in (torch.bfloat16, torch.float32):
        fm = chip_smoke.tied(torch, gen, (5, 320, 320, 64), dtype, dev, 2.0)
        pooled = roi_pool.roi_pool_reference(fm, boxes, mask, 0.25)
        g = torch.randn(pooled.shape, generator=gen, device=dev).to(dtype)
        args = (fm, boxes, mask, pooled, g, 0.25)
        want = roi_pool.roi_pool_backward_reference(*args)
        row = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            roi_pool._bind(lib)
            _build._LIBS["roi_pool"] = lib
            if name == "full":
                got = roi_pool.roi_pool_backward(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError("ablate_roi_bwd: the full kernel "
                                       "differs from its plain version")
            row[name] = sorted(
                chip_smoke.cuda_ms(torch, lambda: roi_pool.roi_pool_backward(
                    *args), reps=20, warmup=2) for _ in range(3))[1]
        _build._LIBS.pop("roi_pool")
        print(json.dumps(dict(dtype=str(dtype), ms=row)), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
