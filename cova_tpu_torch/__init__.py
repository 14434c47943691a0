"""CoVA in PyTorch for NVIDIA Hopper: the port of ``cova_tpu``.

The package mirrors ``cova_tpu``'s module names so that each counterpart is
easy to find, and it imports neither JAX nor anything of ``cova_tpu``. Its
two hot ops, RoIPool and the fused stem BN+ReLU+max-pool, forward and
backward, are CUDA kernels under ``csrc/`` built with ``nvcc`` at first use
(``ops/_build.py``); each has a plain PyTorch version beside it, which is what
runs for tensors on the CPU.

    from cova_tpu_torch import Config, build_model
    from cova_tpu_torch.cli import main   # main(["train" | "eval" | "predict", ...])
"""

from .config import CLASS_NAMES, N_CLASSES, SEED, Config

__version__ = "0.1.0"


def build_model(cfg, device="cuda"):
    from .models.cova import build_model as _build

    return _build(cfg, device=device)


__all__ = [
    "Config",
    "CLASS_NAMES",
    "N_CLASSES",
    "SEED",
    "build_model",
    "__version__",
]
