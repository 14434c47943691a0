"""The port's own build of ``native/cova_native.cpp``
(``cova_tpu_torch/data/native_loader.py``): into a content-hashed directory
that ``.gitignore`` lists, never into ``native/``, and race-free: processes
that build at once on an empty cache all load a whole library."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from cova_tpu_torch.data import native_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD = (
    "import sys\n"
    "from cova_tpu_torch.data import native_loader as n\n"
    "n.BUILD_DIR = sys.argv[1]\n"
    "ok = n.ensure_built()\n"
    "print(ok, n.lib_path())\n"
    "sys.exit(0 if ok and n.load_library() is not None else 1)\n"
)


def _toolchain_or_skip():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    if not native_loader.ensure_built():
        pytest.skip("no libpng headers for native/cova_native.cpp")


def test_build_goes_to_an_ignored_hashed_directory():
    path = native_loader.lib_path()
    native = os.path.join(REPO, "native") + os.sep
    assert not path.startswith(native)
    assert os.path.dirname(os.path.dirname(path)) == native_loader.BUILD_DIR
    rel = os.path.relpath(native_loader.BUILD_DIR, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert rel + "/" in f.read().split()
    assert native_loader.SOURCE == os.path.join(REPO, "native",
                                                "cova_native.cpp")


def test_concurrent_builds_all_load_the_library(tmp_path):
    """Six processes call ``ensure_built`` at once on an empty build
    directory: each returns True and loads the library, one file is left
    (no temporary beside it)."""
    _toolchain_or_skip()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for _ in range(6)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    paths = {out.split()[-1] for out in outs}
    assert len(paths) == 1
    (built,) = paths
    assert os.path.dirname(os.path.dirname(built)) == str(tmp_path)
    assert sorted(os.listdir(os.path.dirname(built))) == [
        "libcova_native.so", "libcova_native.so.lock"]


def test_the_ports_build_decodes_like_pil(tmp_path):
    """The library the port built decodes a page as PIL does and parses
    its bbox CSV."""
    _toolchain_or_skip()
    from PIL import Image

    from cova_tpu_torch.data.synthetic import materialize

    root = str(tmp_path / "pages")
    ids = materialize(root, n_pages=2, img_h=40, seed=1, min_boxes=4,
                      max_boxes=6)
    for pid in ids:
        png = os.path.join(root, "imgs", f"{pid}.png")
        want = np.asarray(Image.open(png).convert("RGB"))
        got = native_loader.decode_png(png, *want.shape[:2])
        np.testing.assert_array_equal(got, want)
        rows = native_loader.parse_bbox_csv(
            os.path.join(root, "bboxes", f"{pid}.csv"))
        want_rows = np.loadtxt(os.path.join(root, "bboxes", f"{pid}.csv"),
                               delimiter=",", skiprows=1, ndmin=2)
        np.testing.assert_allclose(rows, want_rows, rtol=1e-6)
