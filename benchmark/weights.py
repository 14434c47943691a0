"""The weights of a run, made on the device from the seed.

Every tensor of the model's state_dict (``reference.cova.param_shapes``),
drawn in two large calls of one ``torch.Generator`` on the device, in
float32 (the parameters' type; the program computes in bfloat16 from
them): a normal for the convs and the ``normal`` kind, a uniform for the
rest. By kind:

* ``conv``: He normal, std sqrt(2 / fan_in), the normal clipped at 2 std
  and scaled as a truncated normal is (the port's initialiser);
* ``normal``: N(0, std^2), std the entry's third item, clipped at 2 std
  (a table such as a relative-position bias);
* ``linear_w``, ``linear_b``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in
  the entry's third item;
* ``bn_w``, ``bn_var``, ``ln_w``: U(0.8, 1.2); ``bn_b``, ``bn_mean``,
  ``ln_b``: U(-0.1, 0.1) (BatchNorm's weight, bias and running
  statistics, LayerNorm's weight and bias);
* ``bn_count``: the step count, 0;
* ``fixed``: a buffer that draws nothing, the trunk file's
  ``fixed(name, shape, cfg)`` (an index table).

The running statistics stand for a model that has trained: serving reads
them.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict

import torch

from .pages import sub_seed
from .reference.cova import param_shapes, trunk

_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2
_NORMAL = ("conv", "normal")
_DRAWS_NOTHING = ("bn_count", "fixed")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device``, for the configuration ``cfg``."""
    dev = torch.device(device)
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 2))
    n_normal = sum(math.prod(s[0]) for s in shapes.values()
                   if s[1] in _NORMAL)
    n_rest = sum(math.prod(s[0]) for s in shapes.values()
                 if s[1] not in _NORMAL + _DRAWS_NOTHING)
    normal = torch.randn(n_normal, generator=gen, device=dev)
    uniform = torch.rand(n_rest, generator=gen, device=dev)
    out: Dict[str, torch.Tensor] = OrderedDict()
    i_n = i_u = 0
    for name, spec in shapes.items():
        shape, kind = spec[0], spec[1]
        size = math.prod(shape)
        if kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=dev)
            continue
        if kind == "fixed":
            t = trunk(cfg).fixed(name, shape, cfg)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: fixed() gave {tuple(t.shape)}, "
                                 f"not {tuple(shape)}")
            out[name] = t.to(dev)
            continue
        if kind in _NORMAL:
            if kind == "conv":
                std = math.sqrt(2.0 / math.prod(shape[1:])) / _TRUNC_STD
            else:
                std = spec[2]
            t = normal[i_n:i_n + size].clamp(-2.0, 2.0) * std
            i_n += size
        else:
            u = uniform[i_u:i_u + size]
            i_u += size
            if kind in ("linear_w", "linear_b"):
                bound = 1.0 / math.sqrt(spec[2])
                t = (2 * u - 1) * bound
            elif kind in ("bn_w", "bn_var", "ln_w"):
                t = 0.8 + 0.4 * u
            elif kind in ("bn_b", "bn_mean", "ln_b"):
                t = 0.2 * u - 0.1
            else:
                raise ValueError(f"{name}: no draw for the kind {kind!r}")
        out[name] = t.reshape(shape).clone()
    return out
