"""The plain reference against the port's outputs at a tiny size on the
CPU: in float32 they agree to round-off, which shows that the reference
works out the same padding, buckets, context indices and RoI bins."""

import time

import pytest

from benchmark import harness

from .conftest import tiny_cell


@pytest.mark.parametrize("seed", [7, 2**31 + 9])
@pytest.mark.parametrize("workload", ["r18stem.serve.b10",
                                      "r50stem.serve.b10"])
def test_serve_agrees_in_float32(workload, seed):
    cell, cfg, tr, limits, met = tiny_cell(workload, compute_dtype="float32")
    res, _, num = harness.run_cell(cell, cfg, tr, limits, seed, 0.3, False,
                                   "cpu", time.perf_counter(), met)
    assert res["correct"]
    assert num["logit_err"] < 1e-5
    assert num["logit_rel"] < 1e-5
    assert len(num["errs"]) == res["attempted"] > 0


def test_bfloat16_run_reports_its_metrics():
    cell, cfg, tr, limits, met = tiny_cell("r18stem.serve.b10")
    res, lines, num = harness.run_cell(cell, cfg, tr, limits, 11, 0.3,
                                       False, "cpu", time.perf_counter(),
                                       met)
    # An untraced run reports the end-to-end metrics that list its cell.
    assert set(res["metrics"]) == {
        n for n, m in met.items() if "bound" in m
        and cell["name"] in m.get("workloads", [cell["name"]])}
    assert "setup_s" in res["metrics"]
    assert 0 < num["logit_err"] < 0.1
    assert list(res)[-1] == "checks"
    assert lines[-1].startswith("check logit_rel")
