"""The reference's trunks, one file a backbone: ``trunks/<backbone>.py``,
found by the configuration's ``backbone`` as ``manifest.reader`` finds a
metric's file. A configuration with a new trunk brings its file; the
head, RoI pool, weights, counts and harness take it from there.

A trunk file gives:

* ``CHANNELS`` and ``STRIDE``: the feature map's channels, and its stride
  against the screenshot;
* ``param_shapes(cfg)``: its ``convnet.*`` state_dict entries, name ->
  ``(shape, kind[, extra])``, in order (the kinds are ``weights.py``'s);
* ``forward(m, x)``: the plain float32 forward from the images [B, 3, H,
  W] in [0, 1] to [B, CHANNELS, H / STRIDE, W / STRIDE]. ``m`` holds the
  weights and running statistics (``m.w``) and the reference's helpers
  ``m.conv``, ``m.linear``, ``m.bn2d`` and ``m.op``, the control's float8
  rounding of a conv or matmul operand: every operand of one goes through
  ``m.op``, so the control covers the trunk;
* ``flops(cfg)``: a page's trunk forward FLOPs at ``cfg["img_height"]``,
  a multiply-add counted as two;
* ``fixed(name, shape, cfg)``, where ``param_shapes`` lists an entry of
  the kind ``fixed``: that buffer, drawn from nothing;
* the byte counts of its hand-written kernels, which the files in
  ``metrics/`` read by name.

Nothing here imports the program under test.
"""

from __future__ import annotations

import importlib
import re
from types import ModuleType

_NAME = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")


def load(backbone: str) -> ModuleType:
    """The trunk file of ``backbone``."""
    if not _NAME.match(backbone):
        raise ValueError(f"not a backbone name: {backbone!r}")
    name = f"{__name__}.{backbone}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no trunk file for backbone {backbone!r} "
                         f"(reference/trunks/{backbone}.py)") from None
