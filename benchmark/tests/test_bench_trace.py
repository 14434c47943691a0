"""The trace reduction on a small canned trace."""

import json

from benchmark import readers, trace


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


CANNED = [
    _ev("bench.window", "user_annotation", 0, 100),
    _ev("bench.feed", "user_annotation", 0, 10),
    _ev("bench.step", "user_annotation", 10, 5),
    _ev("bench.feed", "user_annotation", 50, 20),
    _ev("bench.step", "user_annotation", 70, 5),
    _ev("aten::copy_", "cpu_op", 1, 3),  # inside bench.feed
    _ev("void roi_pool_bins_kernel<__nv_bfloat16>(int)", "kernel", 12, 20),
    _ev("roi_pool_bins_kernel<float>", "kernel", 20, 20),  # overlaps
    _ev("void at::native::vectorized_elementwise_kernel<4>(int)",
        "kernel", 72, 8),
    _ev("Memcpy HtoD", "gpu_memcpy", 90, 5),
    _ev("outside", "kernel", 150, 10),  # after the window
]


def test_summarize_canned(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": CANNED}))
    s = trace.summarize(trace.load(str(path)))
    assert s["window_s"] == 100e-6
    # busy: [12, 40) + [72, 80) + [90, 95) = 28 + 8 + 5
    assert abs(s["busy_s"] - 41e-6) < 1e-12
    assert s["kernels"]["roi_pool_bins_kernel"][1] == 2
    assert abs(s["kernels"]["roi_pool_bins_kernel"][0] - 40e-6) < 1e-12
    assert "outside" not in s["kernels"]
    assert s["spans"]["bench.feed"][1] == 2
    # idle: [0, 12) [40, 72) [80, 90) [95, 100): 12 + 32 + 10 + 5 = 59.
    # feed covers [0, 10) and [50, 70): 10 + 20; step [10, 15) covers 2
    # and [70, 75) 2; the rest has no host op: 59 - 30 - 4 = 25.
    g = s["gaps"]
    assert abs(g["bench.feed"] - 30e-6) < 1e-12
    assert abs(g["bench.step"] - 4e-6) < 1e-12
    assert abs(g[trace.NO_HOST_OP] - 25e-6) < 1e-12
    assert "bench.window" not in g and "aten::copy_" not in g
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "roi_pool_bins_kernel"
    assert b["idle_gaps"][0][0] == "bench.feed"

    ctx = {"summary": s, "steps": 2}
    assert abs(readers.feed_wait_ms(ctx) - 30e-6 / 2 * 1e3) < 1e-9
    assert abs(readers.device_idle(ctx) - 59.0) < 1e-9
    assert abs(readers.elementwise_ms(ctx) - 8e-6 / 2 * 1e3) < 1e-9
    assert readers.device_idle(dict(ctx, summary=None)) is None


def test_kernel_name():
    assert trace.kernel_name(
        "void (anonymous namespace)::foo_kernel<float, 4>(float*)") == \
        "foo_kernel"
    assert trace.kernel_name("nvjet_tst_64x8_64x16_2x1") == \
        "nvjet_tst_64x8_64x16_2x1"


def test_union():
    assert trace.union([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_roofline_reader_finds_nothing_without_its_kernels():
    ctx = {"steps": 3, "summary": {"kernels": {}},
           "step_counts": {0: 3}, "shapes": lambda j: None}
    assert readers.roofline(ctx, ("k1",), None) is None


def test_batch_p95_reader():
    ctx = {"latencies_s": [i / 1000 for i in range(1, 101)]}
    assert abs(readers.batch_p95_ms(ctx) - 95.05) < 1e-9
    assert readers.batch_p95_ms(dict(ctx, latencies_s=[])) is None
