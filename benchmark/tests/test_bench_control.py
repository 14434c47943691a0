"""The control: the plain reference computed with float8 operands in the
program's place fails the cell's check, at a tiny size on the CPU, and
(on the card) at the cell's own size on three seeds."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, harness, pages, weights
from benchmark.reference import cova as reference

from .conftest import ROOT, tiny_cell

CELLS = ["r18stem.serve.b10", "r50stem.serve.b10"]


def _control(workload, seed):
    cell, cfg, tr, limits, _ = tiny_cell(workload)
    pool = pages.make_pool(tr, cfg, seed, "cpu")
    w = weights.make_weights(cfg, seed, "cpu")
    nb = len(pool.batches)
    all_pages = [pool.batch_pages(j) for j in range(nb)]
    valid = [[len(p["labels"]) for p in b] for b in all_pages]
    ref = reference.serve(w, all_pages, cfg, "cpu")
    ctl = reference.serve(w, all_pages, cfg, "cpu", quant="fp8")
    return limits, check.serve_numbers(list(enumerate(ctl)), ref, valid)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_control_fails_the_check(workload, seed):
    limits, ctl = _control(workload, seed)
    ok, _ = check.judge(ctl, limits)
    assert not ok


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_the_bfloat16_program(workload):
    """At this size too the float8 control's every compared number stands
    well above what the bfloat16 program reads on the same seed."""
    cell, cfg, tr, limits, met = tiny_cell(workload)
    _, _, sound = harness.run_cell(cell, cfg, tr, limits, 3, 0.2, False,
                                   "cpu", time.perf_counter(), met)
    _, ctl = _control(workload, 3)
    for name in limits:
        assert ctl[name] > 2 * sound[name]


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = (reference._round_to(x, torch.float8_e4m3fn) - x).abs().max()
    e16 = (x.bfloat16().float() - x).abs().max()
    assert e8 > 8 * e16


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card_at_full_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only there")
    out = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload", workload,
         "--seconds", "1", "--seeds", "101", "202", "303"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{"seed"')]
    limits = json.load(open(os.path.join(
        ROOT, "benchmark", "limits", f"{workload}.json")))["limits"]
    assert len(rows) == 3
    for row in rows:
        assert row["correct"]
        assert not check.judge(row["control"], limits)[0]
