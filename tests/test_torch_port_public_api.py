"""The port's documented Python API (the root ``__init__`` docstring) must
import, case for case as ``tests/test_public_api.py`` holds the JAX
package's, and ``cova_tpu_torch.data`` must stay free of torch."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_root_api():
    from cova_tpu_torch import CLASS_NAMES, Config, build_model  # noqa: F401

    assert CLASS_NAMES[0] == "BG"


def test_train_api():
    from cova_tpu_torch.train import (  # noqa: F401
        evaluate,
        extract_attention,
        fit,
        predict_pages,
    )

    assert callable(fit) and callable(evaluate)


def test_data_api():
    from cova_tpu_torch.data import (  # noqa: F401
        DataPipeline,
        WebDataset,
        make_pipelines,
    )

    assert hasattr(DataPipeline, "epoch")


def test_unknown_attr_raises():
    import pytest

    import cova_tpu_torch.data as d
    import cova_tpu_torch.train as t

    for pkg in (t, d):
        with pytest.raises(AttributeError):
            pkg.nonexistent_symbol


def test_the_exports_are_the_jax_packages_names():
    import cova_tpu.data
    import cova_tpu.train
    import cova_tpu_torch.data
    import cova_tpu_torch.train

    assert cova_tpu_torch.data.__all__ == cova_tpu.data.__all__
    assert cova_tpu_torch.train.__all__ == cova_tpu.train.__all__


def test_data_package_loads_no_torch():
    """Importing the data package, as its docstring promises, loads no
    torch (a fresh interpreter: this one has torch already)."""
    code = ("import sys, cova_tpu_torch.data; "
            "sys.exit('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
