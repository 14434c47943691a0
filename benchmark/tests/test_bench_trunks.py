"""The trunks as files of their own (``reference/trunks/<backbone>.py``).

* The readings of the two ResNet cells are those of the benchmark before
  the trunks moved out of its shared files: the weights, the reference's
  logits and the counts are pinned by digests and numbers taken on the
  commit before the move (the same script on both trees, on the CPU with
  one thread, torch 2.13.0+cpu: a thread count or a torch build of its
  own may round or draw other bits).
* Every trunk file gives what ``trunks/__init__.py`` lists.
* A configuration with a trunk of its own reaches the benchmark through
  added files and added entries alone: a copy of the benchmark with a
  test-only trunk runs its manifest, weights, reference, control, counts
  and a whole run on the CPU, and differs from the benchmark only by what
  it adds.
* K9's bytes, which the ResNet trunk files count, against a hand count.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import counts, manifest, pages, weights
from benchmark.reference import cova as reference
from benchmark.reference import trunks

from .conftest import ROOT, tiny_cell

SEEDS = [0, 2**31 + 9]
CONFIGS = ["cova-r18stem", "cova-r50stem"]
CELLS = ["r18stem.serve.b10", "r50stem.serve.b10"]

WEIGHTS = {
    ("cova-r18stem", 0):
        "8aaf511dc4266e296bb19c5e80cade87c8bbac81533e57dc3b6ba3de95933948",
    ("cova-r18stem", 2**31 + 9):
        "b9a563e72487af812cc04424487df563347e3fde7ac69de9953682a8bd21cd24",
    ("cova-r50stem", 0):
        "167c6c19d7b0c2857d9879eab9e811a9e68e7160209b6a4ff93f20f98e5e45cf",
    ("cova-r50stem", 2**31 + 9):
        "16829c1a9c562d59a7c5eca34fdec02340f5ad77dead387a024ac061240ec837",
}
# The tiny cells' reference logits in float32 and under the float8
# control, and per pool batch K1's bytes, K5's bytes and the step's FLOPs.
LOGITS = {
    ("r18stem.serve.b10", 0, None):
        "7dc3997791598b08f694d25804ce76fb0e269f8c342eb62eb118db6d093c5a25",
    ("r18stem.serve.b10", 0, "fp8"):
        "34d879cc0c8f0158e21ec6a7f315242215720ec4f8243d7bcba877db44803e5f",
    ("r18stem.serve.b10", 2**31 + 9, None):
        "125967016d7cef8d4815f44db90b91986fbc05188f4c2a4aaedf9c13eae95838",
    ("r18stem.serve.b10", 2**31 + 9, "fp8"):
        "55dc6a017453e8b96c880a741586f13793062621997cc9c6d408cc58247c4523",
    ("r50stem.serve.b10", 0, None):
        "a558b54a668990012da6e30fd5da331af0da92bc97d4fab373054c799e93a229",
    ("r50stem.serve.b10", 0, "fp8"):
        "bf8025a7b96b31795eaae9e70cca66b127ddf1d842a37e20f3e78cb1708d86ac",
    ("r50stem.serve.b10", 2**31 + 9, None):
        "f5edb0d78fe9ed0df2dab677100755d21e7769d3ca0a13944baeebd2fc174c7d",
    ("r50stem.serve.b10", 2**31 + 9, "fp8"):
        "186b083674438f9dbfab2c8333ed019b8e69a6af2d6e8a678d7278d464ae7a88",
}
COUNTS = {
    ("r18stem.serve.b10", 0): [
        [519536, 1638912, 1035339440.0], [515056, 1638912, 1038389488.0],
        [500080, 1638912, 1038389488.0]],
    ("r18stem.serve.b10", 2**31 + 9): [
        [488432, 1638912, 1035339440.0], [501104, 1638912, 1038389488.0],
        [487024, 1638912, 1038389488.0]],
    ("r50stem.serve.b10", 0): [
        [2065904, 1638912, 2548895920.0], [2047984, 1638912, 2592920304.0],
        [1988080, 1638912, 2592920304.0]],
    ("r50stem.serve.b10", 2**31 + 9): [
        [1941488, 1638912, 2548895920.0], [1992176, 1638912, 2592920304.0],
        [1935856, 1638912, 2592920304.0]],
}


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _digest_tensors(named) -> str:
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _digest_arrays(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", CONFIGS)
def test_weights_are_those_before_the_move(config, seed, one_thread):
    cfg = manifest.Benchmark(ROOT).config(config)
    w = weights.make_weights(cfg, seed, "cpu")
    assert _digest_tensors(w.items()) == WEIGHTS[config, seed]


def _tiny_pool(workload, seed):
    _, cfg, tr, _, _ = tiny_cell(workload)
    pool = pages.make_pool(tr, cfg, seed, "cpu")
    return cfg, [pool.batch_pages(j) for j in range(len(pool.batches))]


@pytest.mark.parametrize("quant", [None, "fp8"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_reference_logits_are_those_before_the_move(workload, seed, quant,
                                                    one_thread):
    cfg, batches = _tiny_pool(workload, seed)
    w = weights.make_weights(cfg, seed, "cpu")
    logits = reference.serve(w, batches, cfg, "cpu", quant=quant)
    assert _digest_arrays(logits) == LOGITS[workload, seed, quant]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_counts_are_those_before_the_move(workload, seed):
    cfg, batches = _tiny_pool(workload, seed)
    got = []
    for b in batches:
        p = reference.bucket(max(len(pg["labels"]) for pg in b), cfg)
        sh = counts.batch_shapes(b, cfg, p)
        got.append([counts.roi_pool_bytes(sh), counts.bn_pool_bytes(sh),
                    counts.step_flops(cfg, sh["valid"])])
    assert got == COUNTS[workload, seed]


def test_bn_act_bytes_by_hand():
    """K9 at B = 10 and 1280², bf16: a Bottleneck moves 4 N64 + 4 N64 +
    6 N256 bytes, a BasicBlock 4 N64 + 6 N64 (N_c the elements of a
    [10, 320, 320, c] map), plus each launch's f32 scale and shift and,
    on r50's first block, the folded downsample BN's pair."""
    sh = {"b": 10, "h": 320, "w": 320, "itemsize": 2}
    n64, n256 = 10 * 320 * 320 * 64, 10 * 320 * 320 * 256
    r50 = trunks.load("resnet50_stem").bn_act_bytes(sh)
    r18 = trunks.load("resnet18_stem").bn_act_bytes(sh)
    assert 3 * (4 * n64 + 4 * n64 + 6 * n256) == 6_291_456_000
    assert 2 * (4 * n64 + 6 * n64) == 1_310_720_000
    assert r50 == 6_291_456_000 + 3 * (8 * 64 + 8 * 64 + 8 * 256) + 8 * 256
    assert r18 == 1_310_720_000 + 2 * (8 * 64 + 8 * 64)
    f32 = trunks.load("resnet18_stem").bn_act_bytes(dict(sh, itemsize=4))
    assert f32 == 2 * 1_310_720_000 + 2 * (8 * 64 + 8 * 64)


TRUNK_DIR = os.path.join(ROOT, "benchmark", "reference", "trunks")
TRUNK_FILES = sorted(f[:-3] for f in os.listdir(TRUNK_DIR)
                     if f.endswith(".py") and not f.startswith("_"))


@pytest.mark.parametrize("backbone", TRUNK_FILES)
def test_each_trunk_file_gives_what_the_benchmark_reads(backbone):
    t = trunks.load(backbone)
    cfg = dict(tiny_cell("r18stem.serve.b10")[1], backbone=backbone)
    shapes = t.param_shapes(cfg)
    assert shapes and all(n.startswith("convnet.") for n in shapes)
    assert list(shapes) == [n for n in reference.param_shapes(cfg)
                            if n.startswith("convnet.")]
    w = weights.make_weights(cfg, 1, "cpu")
    m = reference._Model(cfg, {n: v.float() if v.is_floating_point() else v
                               for n, v in w.items()}, None)
    s = cfg["img_height"]
    with torch.no_grad():
        fm = t.forward(m, torch.rand(2, 3, s, s))
    assert fm.shape == (2, t.CHANNELS, s // t.STRIDE, s // t.STRIDE)
    assert fm.dtype == torch.float32
    assert t.flops(cfg) > 0


def test_a_backbone_without_a_file_is_refused():
    for name in ("resnet99_stem", "../cova", "_resnet_stem"):
        with pytest.raises(ValueError):
            trunks.load(name)


# ---- a trunk that arrives as new files ------------------------------------

TOY_TRUNK = '''"""A trunk for the benchmark's tests only: a 4x4/4 patch
embedding (conv with bias), LayerNorm over the channels, and a
per-channel bias looked up in a table by a fixed index buffer."""

from collections import OrderedDict

import torch.nn.functional as F

CHANNELS, STRIDE = 24, 4
ROWS = 7


def param_shapes(cfg):
    c = CHANNELS
    return OrderedDict([
        ("convnet.embed.weight", ((c, 3, 4, 4), "conv")),
        ("convnet.embed.bias", ((c,), "linear_b", 48)),
        ("convnet.norm.weight", ((c,), "ln_w")),
        ("convnet.norm.bias", ((c,), "ln_b")),
        ("convnet.table", ((ROWS, c), "normal", 0.5)),
        ("convnet.index", ((c,), "fixed")),
    ])


def fixed(name, shape, cfg):
    import torch

    return (torch.arange(shape[0]) * 5) % ROWS


def forward(m, x):
    y = m.conv(x, "convnet.embed.weight", stride=STRIDE)
    y = y + m.w["convnet.embed.bias"][:, None, None]
    y = F.layer_norm(y.permute(0, 2, 3, 1), (CHANNELS,),
                     m.w["convnet.norm.weight"], m.w["convnet.norm.bias"])
    bias = m.w["convnet.table"].gather(0, m.w["convnet.index"][None])
    return (y + bias[0]).permute(0, 3, 1, 2)


def flops(cfg):
    side = cfg["img_height"] // STRIDE
    return 2.0 * side * side * CHANNELS * 48
'''

TOY_CONFIG = "toy-patch4"
TOY_CELL = "toy.serve.b10"

# In the copy: the run's pieces on the toy trunk, with a plain model of it
# (the reference's own forward, fed from the port's device batch) in the
# place of the port, which has no such trunk.
DRIVE = r'''
import json, sys, time
copy, repo = sys.argv[1], sys.argv[2]
sys.path[:0] = [copy, repo]
import torch
torch.set_num_threads(2)
import benchmark
from benchmark import check, counts, harness, manifest, pages, program
from benchmark import weights
from benchmark.reference import cova as reference
from benchmark.tests.conftest import tiny_cell

out = {"package": benchmark.__file__}
bench = manifest.Benchmark(copy)
cell, cfg, tr, lim, met = tiny_cell("%(cell)s")
out["readers"] = sorted(bench.readers(cell["name"]))
seed = 2**31 + 11
w = weights.make_weights(cfg, seed, "cpu")
t = reference.trunk(cfg)
out["kinds"] = {
    "index": w["convnet.index"].tolist(),
    "index_dtype": str(w["convnet.index"].dtype),
    "table_std": float(w["convnet.table"].std()),
    "table_absmax": float(w["convnet.table"].abs().max()),
    "ln_w": [float(w["convnet.norm.weight"].min()),
             float(w["convnet.norm.weight"].max())],
    "ln_b": [float(w["convnet.norm.bias"].min()),
             float(w["convnet.norm.bias"].max())],
}
pool = pages.make_pool(tr, cfg, seed, "cpu")
batches = [pool.batch_pages(j) for j in range(len(pool.batches))]
valid = [[len(p["labels"]) for p in b] for b in batches]
ref = reference.serve(w, batches, cfg, "cpu")
ctl = reference.serve(w, batches, cfg, "cpu", quant="fp8")
num = check.serve_numbers(list(enumerate(ctl)), ref, valid)
out["control"] = {"correct": check.judge(num, lim)[0],
                  "logit_rel": num["logit_rel"]}
out["logits_shape"] = list(ref[0].shape)
out["finite"] = all(bool(abs(r).max() < 1e30) for r in ref)
sh = counts.batch_shapes(batches[0], cfg, reference.bucket(
    max(valid[0]), cfg))
out["counts"] = {"trunk_flops": counts.trunk_flops(cfg),
                 "want_flops": t.flops(cfg), "c": sh["c"], "h": sh["h"],
                 "box_flops": counts.box_flops(cfg)}


def build_model(cfg, w, dev):
    return reference._Model(cfg, {
        n: v.float() if v.is_floating_point() else v for n, v in w.items()},
        None)


def serve(model, batch):
    f = {k: torch.as_tensor(v) for k, v in batch._asdict().items()}
    b, h4, w4, _ = f["images"].shape
    images = f["images"].reshape(b, h4, w4, 4, 4, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(b, 4 * h4, 4 * w4, 3)
    t = {"images": images, "boxes": f["boxes"].float(),
         "mask": f["box_mask"].bool(), "ctx": f["context_indices"].long()}
    with torch.no_grad(), reference.float32_exact():
        return model(t)


program.build_model = build_model
program.serve = serve
for traced in (False, True):
    res, _, num = harness.run_cell(
        cell, cfg, tr, lim, seed, 0.3, traced, "cpu", time.perf_counter(),
        met, bench.readers(cell["name"]) if traced else None)
    out["traced" if traced else "untraced"] = {
        "correct": res["correct"], "attempted": res["attempted"],
        "failed": res["failed"], "metrics": sorted(res["metrics"]),
        "logit_rel": num["logit_rel"]}
k9 = manifest.reader("bn_act_roofline.serve")
out["k9"] = k9({"config": cfg, "summary": None, "steps": 1})
print("RESULT " + json.dumps(out))
'''


def _only_added(old, new, where="BENCHMARK.json"):
    """``new`` is ``old`` with entries added: every key of a dict kept
    with its value (recursively), every list a prefix of its new one."""
    if isinstance(old, dict):
        assert isinstance(new, dict), where
        for k, v in old.items():
            assert k in new, f"{where}: {k} removed"
            _only_added(v, new[k], f"{where}.{k}")
    elif isinstance(old, list):
        assert isinstance(new, list) and len(new) >= len(old), where
        for i, v in enumerate(old):
            _only_added(v, new[i], f"{where}[{i}]")
    else:
        assert old == new, f"{where}: {old!r} -> {new!r}"


def _add_toy(copy):
    """The new trunk's files and entries, added to the copy."""
    bench = os.path.join(copy, "benchmark")
    with open(os.path.join(bench, "reference", "trunks",
                           "patch4_table.py"), "w") as f:
        f.write(TOY_TRUNK)
    cfg = manifest.load_json(os.path.join(bench, "configs",
                                          "cova-r18stem.json"))
    cfg.update(name=TOY_CONFIG, backbone="patch4_table",
               trunk="test only: patch4_table.py")
    with open(os.path.join(bench, "configs", TOY_CONFIG + ".json"),
              "w") as f:
        json.dump(cfg, f, indent=2)
    with open(os.path.join(bench, "limits", TOY_CELL + ".json"), "w") as f:
        json.dump({"limits": {"logit_rel": 0.024}}, f)
    path = os.path.join(copy, "BENCHMARK.json")
    spec = manifest.load_json(path)
    spec["configs"].append({
        "name": TOY_CONFIG, "source": "benchmark/tests/test_bench_trunks.py",
        "file": f"benchmark/configs/{TOY_CONFIG}.json", "reduced": [],
        "why": "a test-only trunk"})
    spec["workloads"].append({
        "name": TOY_CELL, "config": TOY_CONFIG, "traffic": "serve_b10",
        "chips": 1, "why": "a test-only trunk under the CoVA head"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("serve_pages_per_s", "mfu.serve"):
            m["workloads"].append(TOY_CELL)
    with open(path, "w") as f:
        json.dump(spec, f, indent=1)


def test_a_trunk_arrives_as_new_files(tmp_path):
    copy = str(tmp_path / "copy")
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(copy, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    _add_toy(copy)

    # What a diff -r shows: files and entries added, none changed.
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "benchmark")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            with open(os.path.join(ROOT, rel), "rb") as a, \
                    open(os.path.join(copy, rel), "rb") as b:
                assert a.read() == b.read(), rel
    _only_added(manifest.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                manifest.load_json(os.path.join(copy, "BENCHMARK.json")))

    drive = tmp_path / "drive.py"
    drive.write_text(DRIVE % {"cell": TOY_CELL})
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    run = subprocess.run([sys.executable, str(drive), copy, ROOT],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-4000:]
    line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")]
    assert line, run.stdout[-2000:]
    out = json.loads(line[-1][len("RESULT "):])

    assert out["package"].startswith(copy)
    assert out["readers"] == ["mfu.serve"]
    kinds = out["kinds"]
    assert kinds["index"] == [(c * 5) % 7 for c in range(24)]
    assert kinds["index_dtype"] == "torch.int64"
    assert 0.3 < kinds["table_std"] < 0.6 and kinds["table_absmax"] <= 1.0
    assert 0.8 <= kinds["ln_w"][0] <= kinds["ln_w"][1] <= 1.2
    assert -0.1 <= kinds["ln_b"][0] <= kinds["ln_b"][1] <= 0.1
    assert out["finite"] and out["logits_shape"][-1] == 4
    assert not out["control"]["correct"]
    c = out["counts"]
    assert c["trunk_flops"] == c["want_flops"] == 2.0 * 16 * 16 * 24 * 48
    assert (c["c"], c["h"]) == (24, 16)
    nf = 24 * 9 + 8
    assert c["box_flops"] > 2 * 2.0 * nf * 16
    for side in ("untraced", "traced"):
        r = out[side]
        assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
        assert r["logit_rel"] < 1e-6
    assert out["untraced"]["metrics"] == ["serve_pages_per_s", "setup_s"]
    assert out["traced"]["metrics"] == ["mfu.serve"]
    assert out["k9"] is None
