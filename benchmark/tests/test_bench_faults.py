"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and runs a tiny cell on the
CPU through the port's own steps with a fault planted in the port's
forward. The cells serve on one chip, so there is no exchange between
chips to leave out, and no state that a step carries; the faults a
serving cell can have are an answer altered where the model produces it,
and half of the batch left out (its pages given the answers of the other
half).
"""

import time

import pytest

import cova_tpu_torch.models.cova as port_model
from benchmark import harness

from .conftest import tiny_cell

CELLS = ["r18stem.serve.b10", "r50stem.serve.b10"]


def _run(workload, seed=21):
    cell, cfg, tr, limits, met = tiny_cell(workload)
    res, _, num = harness.run_cell(cell, cfg, tr, limits, seed, 0.3, False,
                                   "cpu", time.perf_counter(), met)
    return res, num


def _plant(monkeypatch, change):
    """Each call of the port's forward returns ``change(logits, n)``, n
    the call's number, in place of its logits where that is not None."""
    forward = port_model.CoVA.forward
    calls = []

    def planted(self, *a, **kw):
        out = forward(self, *a, **kw)
        calls.append(1)
        logits = change(out.logits.clone(), len(calls))
        return out if logits is None else out._replace(logits=logits)

    monkeypatch.setattr(port_model.CoVA, "forward", planted)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(workload):
    res, _ = _run(workload)
    assert res["correct"]
    assert res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_where_produced(monkeypatch, workload):
    def alter(logits, call):
        if call != 7:  # one answer inside the window
            return None
        logits[0, 0, 1] += logits.abs().max() * 0.5
        return logits

    _plant(monkeypatch, alter)
    res, _ = _run(workload)
    assert not res["correct"]
    assert res["failed"] == 1


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_left_out(monkeypatch, workload):
    def half(logits, call):
        b = logits.shape[0]
        kept = -(-b // 2)
        logits[kept:] = logits[:b - kept]
        return logits

    _plant(monkeypatch, half)
    res, _ = _run(workload)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0
