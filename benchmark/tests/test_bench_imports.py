"""Nothing the benchmark's command runs loads JAX or the JAX package, by
whole top-level module names; the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

from .conftest import ROOT

sys.path.insert(0, os.path.join(ROOT, "benchmark"))
from run import forbidden_modules  # noqa: E402


def test_top_level_names_compared_whole():
    mods = ["cova_tpu_torch", "cova_tpu_torch.ops", "jaxtyping", "flaxen",
            "numpy"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["cova_tpu.ops", "jax", "jaxlib.xla",
                                     "flax.linen"]) == [
        "cova_tpu.ops", "flax.linen", "jax", "jaxlib.xla"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    """The reference's files, its trunk files in ``trunks/`` among them."""
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    seen = set()
    for dirpath, _, files in os.walk(ref_dir):
        for f in files:
            if f.endswith(".py"):
                seen.add(os.path.relpath(os.path.join(dirpath, f), ref_dir))
                mods = set(_imports(os.path.join(dirpath, f)))
                assert not mods & {"cova_tpu_torch", "cova_tpu", "jax",
                                   "jaxlib", "flax"}, f
    assert {"cova.py", os.path.join("trunks", "resnet18_stem.py"),
            os.path.join("trunks", "resnet50_stem.py")} <= seen


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness, program, calibrate, manifest\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "import time\n"
        "cell, cfg, tr, lim, met = tiny_cell('r18stem.serve.b10')\n"
        "harness.run_cell(cell, cfg, tr, lim, 3, 0.2, False, 'cpu',\n"
        "                 time.perf_counter(), met)\n"
        "sys.path.insert(0, %r)\n"
        "from run import forbidden_modules\n"
        "print('BAD', forbidden_modules(sys.modules))\n"
    ) % (ROOT, os.path.join(ROOT, "benchmark"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout[-2000:]


def test_run_refuses_without_cuda_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "r18stem.serve.b10", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
