"""The readers of the port's own spans and counters (``port_readers.py``):
on canned records, where they find nothing, and in a traced CPU run; and
the trace reduction unmoved by the port's ranges nested in the harness's
spans."""

import json
import time

import pytest

from benchmark import harness, manifest, port_readers, readers, trace

from .conftest import ROOT, tiny_cell
from .test_bench_trace import CANNED, _ev

STAGE = "cova_tpu_torch.feed.stage"
STEP = "cova_tpu_torch.forward_step"

# The port's ranges inside the canned trace's harness spans: the feed's
# inside both bench.feed spans, the step's inside both bench.step spans.
NESTED = CANNED + [
    _ev("cova_tpu_torch.feed.source", "user_annotation", 0, 2),
    _ev(STAGE, "user_annotation", 2, 7),
    _ev("cova_tpu_torch.feed.slot_wait", "user_annotation", 2, 1),
    _ev("cova_tpu_torch.feed.h2d", "user_annotation", 9, 1),
    _ev(STAGE, "user_annotation", 51, 18),
    _ev(STEP, "user_annotation", 10.5, 4),
    _ev("cova_tpu_torch.graph.replay", "user_annotation", 11, 3),
    _ev(STEP, "user_annotation", 71, 3),
]


def _summary(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.summarize(trace.load(str(path)))


def test_nested_port_ranges_leave_the_summary_as_it_was(tmp_path):
    plain = _summary(tmp_path, CANNED)
    nested = _summary(tmp_path, NESTED)
    assert nested == plain
    assert trace.breakdown(nested) == trace.breakdown(plain)
    ctx = {"summary": nested, "steps": 2}
    for read in (readers.feed_wait_ms, readers.device_idle,
                 readers.elementwise_ms):
        assert read(ctx) == read(dict(ctx, summary=plain))


RECORD = {STAGE + ".s": 0.006, STAGE + ".calls": 3, STEP + ".s": 0.0015,
          STEP + ".calls": 3, "graph.replays.forward": 3}


def test_span_ms_on_a_canned_record():
    ctx = {"summary": {}, "steps": 3}
    assert port_readers.span_ms(ctx, STAGE, RECORD) == pytest.approx(2.0)
    assert port_readers.span_ms(ctx, STEP, RECORD) == pytest.approx(0.5)
    # Nothing to read: no trace, no steps, no record, no such span.
    assert port_readers.span_ms(dict(ctx, summary=None), STAGE,
                                RECORD) is None
    assert port_readers.span_ms(dict(ctx, steps=0), STAGE, RECORD) is None
    assert port_readers.span_ms(ctx, STAGE, None) is None
    assert port_readers.span_ms(ctx, "cova_tpu_torch.other", RECORD) is None


def test_replay_pct_on_a_canned_record():
    ctx = {"summary": {}, "steps": 3}
    assert port_readers.replay_pct(ctx, "forward", RECORD) == 100.0
    mixed = dict(RECORD, **{"graph.eager.forward": 1,
                            "graph.captures.forward": 1,
                            "graph.replays.forward": 2})
    assert port_readers.replay_pct(ctx, "forward", mixed) == 50.0
    assert port_readers.replay_pct(ctx, "eval", RECORD) is None
    assert port_readers.replay_pct(ctx, "forward", None) is None
    assert port_readers.replay_pct(dict(ctx, summary=None), "forward",
                                   RECORD) is None


@pytest.mark.parametrize("name", ["feed_stage_ms.serve",
                                  "step_host_ms.serve",
                                  "graph_replay_pct.serve"])
def test_the_reader_files_find_nothing_without_a_trace(name):
    read = manifest.reader(name)
    assert read({"summary": None, "steps": 3}) is None


def test_a_traced_cpu_run_reports_the_step_host_ms(monkeypatch):
    """On the CPU the forward step runs eagerly, and the feed stages
    nothing: the step's span is read, the staging and replay shares are
    not."""
    from cova_tpu_torch.utils import tracing

    # The record of this run alone, as a run's own process holds it.
    before = tracing.traced()
    monkeypatch.setattr(port_readers, "traced", lambda: {
        k: v for k, v in tracing.since(before, tracing.traced()).items()
        if v})
    cell, cfg, tr, lim, met = tiny_cell("r18stem.serve.b10")
    bench = manifest.Benchmark(ROOT)
    result, _, _ = harness.run_cell(
        cell, cfg, tr, lim, 3, 0.5, True, "cpu", time.perf_counter(), met,
        bench.readers(cell["name"]))
    got = result["metrics"]
    assert got["step_host_ms.serve"]["unit"] == "ms"
    assert got["step_host_ms.serve"]["value"] > 0
    assert "feed_stage_ms.serve" not in got
    assert "graph_replay_pct.serve" not in got
