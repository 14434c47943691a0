"""The Swin-T stage-1 configuration (``cova-swint1``) and its cell's pieces:
the trunk file's counts against hand counts, the weights it draws, the
reference and its float8 control on a tiny copy of the configuration, and
the readers of its blocks (``window_attn_roofline.serve``,
``layernorm_ms.serve``) on a synthetic run."""

import numpy as np
import pytest
import torch

from benchmark import check, counts, manifest, pages, weights
from benchmark.reference import cova as reference
from benchmark.reference import trunks

from .conftest import ROOT, tiny_cell

CELL = "swint1.serve.b10"
T = trunks.load("swin_t_stage1")


def _config():
    bench = manifest.Benchmark(ROOT)
    return bench.config(bench.cell(CELL)["config"])


def test_flops_by_hand():
    """At 1280^2: 102,400 tokens, 46 x 46 windows of 49 on the padded
    322^2 map. Embedding 2 * 48 * 96 a token; a block's qkv, proj and MLP
    2 * 96 * (288 + 96 + 768) a token, q k^T and P v 2 * 2 * 49^2 * 96 a
    window."""
    tokens, windows = 320 * 320, 46 * 46
    embed = 2 * 48 * 96 * tokens
    block = 2 * 96 * (288 + 96 + 2 * 384) * tokens \
        + 2 * 2 * 49 * 49 * 96 * windows
    assert (embed, block) == (943_718_400, 24_600_159_744)
    assert T.flops(_config()) == embed + 2 * block == 50_144_037_888
    assert counts.trunk_flops(_config()) == 50_144_037_888


def test_window_attn_bytes_by_hand():
    """K10 at B = 10 and 1280^2 in bf16: each of its two launches reads
    the qkv [10, 320, 320, 288] and writes [10, 320, 320, 96], plus the
    gathered bias [3, 49, 49] f32 and the 288 bf16 of the qkv bias."""
    sh = {"b": 10, "h": 320, "w": 320, "itemsize": 2}
    assert 2 * 10 * 320 * 320 * (288 + 96) * 2 == 1_572_864_000
    table = 2 * (3 * 49 * 49 * 4 + 288 * 2)
    assert T.window_attn_bytes(sh) == 1_572_864_000 + table
    assert counts.bound_seconds(T.window_attn_bytes(sh) / 2) == \
        pytest.approx(0.2348e-3, abs=1e-7)


def test_weights_of_the_cell():
    cfg = _config()
    w = weights.make_weights(cfg, 2**31 + 5, "cpu")
    assert list(w) == list(reference.param_shapes(cfg))
    tables = torch.cat([
        w[f"convnet.layers.0.blocks.{i}.attn.relative_position_bias_table"]
        .flatten() for i in range(2)])
    assert tables.numel() == 2 * 169 * 3
    assert 0.9 < float(tables.std()) < 1.05  # N(0, 1) clipped at +-2
    assert float(tables.abs().max()) <= 2.0
    index = w["convnet.layers.0.blocks.0.attn.relative_position_index"]
    assert index.dtype == torch.int64 and index.shape == (49, 49)
    assert int(index[0, 0]) == 84 and int(index.max()) == 168
    assert int(index[48, 0]) == 168 and int(index[0, 48]) == 0
    norm = w["convnet.norm0.weight"]
    assert 0.8 <= float(norm.min()) <= float(norm.max()) <= 1.2
    qkv = w["convnet.layers.0.blocks.1.attn.qkv.weight"]
    assert float(qkv.abs().max()) <= 96 ** -0.5
    assert w["gat.W_i.weight"].shape == (384, 96 * 9 + 32)


def test_reference_and_control_on_a_tiny_copy():
    _, cfg, tr, lim, _ = tiny_cell(CELL)
    seed = 2**31 + 13
    pool = pages.make_pool(tr, cfg, seed, "cpu")
    batches = [pool.batch_pages(j) for j in range(len(pool.batches))]
    valid = [[len(p["labels"]) for p in b] for b in batches]
    w = weights.make_weights(cfg, seed, "cpu")
    ref = reference.serve(w, batches, cfg, "cpu")
    ctl = reference.serve(w, batches, cfg, "cpu", quant="fp8")
    for r, b in zip(ref, batches):
        assert r.shape[0] == len(b) and r.shape[-1] == 4
        assert np.isfinite(r).all()
    num = check.serve_numbers(list(enumerate(ctl)), ref, valid)
    assert num["logit_rel"] > lim["logit_rel"]
    assert not check.judge(num, lim)[0]
    same = check.serve_numbers(list(enumerate(ref)), ref, valid)
    assert same["logit_rel"] == 0.0


def _ctx(steps=4, kernel_s=None, kernels=None):
    cfg = _config()
    sh = {"b": 10, "h": 320, "w": 320, "itemsize": 2}
    summary = {"kernels": dict(kernels or {}), "spans": {}, "gaps": {},
               "busy_s": 1.0, "window_s": 2.0}
    if kernel_s is not None:
        summary["kernels"]["window_attn_kernel"] = [kernel_s, 2 * steps]
    return {"config": cfg, "summary": summary, "steps": steps,
            "window_s": 2.0, "step_counts": {0: steps},
            "latencies_s": [], "shapes": lambda j: sh}


def test_window_attn_roofline_reader():
    read = manifest.reader("window_attn_roofline.serve")
    bound = counts.bound_seconds(T.window_attn_bytes(
        {"b": 10, "h": 320, "w": 320, "itemsize": 2}))
    assert read(_ctx(4, kernel_s=4 * bound * 2)) == pytest.approx(50.0)
    assert read(_ctx(4)) is None  # K10 did not run
    assert read(dict(_ctx(4), summary=None)) is None
    r50 = dict(_ctx(4, kernel_s=1.0), config=manifest.Benchmark(ROOT).config(
        "cova-r50stem"))
    assert read(r50) is None  # a trunk without K10


def test_layernorm_ms_reader():
    """Device ms a step in PyTorch's LayerNorm kernels, vectorized or
    generic, and nothing else."""
    read = manifest.reader("layernorm_ms.serve")
    ln = {"at::native::vectorized_layer_norm_kernel": [0.028, 24],
          "at::native::LayerNormForwardCUDAKernel": [0.004, 4],
          "at::native::vectorized_elementwise_kernel": [1.0, 99],
          "window_attn_kernel": [0.5, 8]}
    assert read(_ctx(4, kernels=ln)) == pytest.approx(8.0)
    assert read(_ctx(4, kernels={"window_attn_kernel": [0.5, 8]})) is None
    assert read(_ctx(0, kernels=ln)) is None  # no step in the window
    assert read(dict(_ctx(4, kernels=ln), summary=None)) is None
