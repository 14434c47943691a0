"""PEP 562 re-exports for package ``__init__``s: a name resolves on first
use, so importing a package loads none of its modules (``cova_tpu_torch.data``
stays free of torch)."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple


def make_lazy_getattr(exports: Dict[str, Tuple[str, str]], pkg: str):
    """A module-level ``__getattr__`` that resolves ``exports`` entries
    ``name -> (submodule, attr)`` relative to package ``pkg`` and raises
    ``AttributeError`` for any other name."""

    def __getattr__(name):
        try:
            mod, attr = exports[name]
        except KeyError:
            raise AttributeError(
                f"module {pkg!r} has no attribute {name!r}") from None
        return getattr(importlib.import_module(f".{mod}", pkg), attr)

    return __getattr__
