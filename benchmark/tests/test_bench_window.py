"""The window's late readback: each step's logits are read ``lag`` steps
after they were sent, in the order sent, and the drain at the window's
close reads every step that is left."""

import time

import pytest
import torch

from benchmark import harness

from .conftest import tiny_cell


@pytest.mark.parametrize("lag", [0, 1, 3])
def test_answers_read_lag_steps_late_in_order(lag):
    out = harness._Answers(torch.device("cpu"), lag)
    read = []
    for k in range(6):
        out.put(k, torch.full((2, 3, 4), float(k)))
        got = list(out.due())
        assert len(out.pending) == min(k + 1, lag)
        read += got
    read += list(out.due(drain=True))
    assert [k for k, _ in read] == list(range(6))
    for k, arr in read:
        assert arr.shape == (2, 3, 4) and (arr == k).all()
    assert not out.pending
    assert len(out.free[(2, 3, 4)]) == lag + 1  # reused, never more


@pytest.mark.parametrize("lag", [0, 8])
def test_window_counts_every_step_it_sent(lag):
    cell, cfg, tr, limits, met = tiny_cell("r18stem.serve.b10")
    tr = dict(tr, readback_lag=lag)
    res, lines, num = harness.run_cell(cell, cfg, tr, limits, 5, 0.3, False,
                                       "cpu", time.perf_counter(), met)
    assert res["correct"]
    assert res["attempted"] == len(num["rels"]) > lag
    assert any(line.startswith("host ms a step: ") for line in lines)
