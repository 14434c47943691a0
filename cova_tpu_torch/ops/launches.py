"""The port's one registry of kernel wrappers that count their launches.

Each wrapper adds one to its ``launches`` attribute where it launches its
kernel on a CUDA tensor, and nowhere else (its plain version on the CPU
counts nothing). A CUDA graph replay calls no wrapper, so the step graphs
(``train/graphs.py``) add the counts that a graph's capture recorded at
each replay, through ``add``: after a run the counters hold what an eager
run of the same steps would have counted.
"""

from __future__ import annotations

from typing import Dict

from . import bn_act, bn_pool, conv3x3, layernorm, roi_pool, window_attn

# Every kernel wrapper that counts its launches, by kernel name: the
# wrappers themselves, not their module attributes, so that a caller that
# swaps a module's wrapper for its plain version (as chip_smoke.py's plain
# runs do) leaves the counters here in place.
WRAPPERS = {"roi_pool_fwd": roi_pool.roi_pool,
            "bn_relu_pool_fwd": bn_pool.bn_relu_pool_s2d,
            "roi_pool_bwd": roi_pool.roi_pool_backward,
            "bn_relu_pool_bwd": bn_pool.bn_relu_pool_s2d_backward,
            "conv3x3_fwd": conv3x3.conv3x3,
            "conv3x3_roll_fwd": conv3x3.conv3x3_roll,
            "bn_act": bn_act.bn_act,
            "window_attn": window_attn.window_attention,
            "layernorm": layernorm.layernorm}


def counts() -> Dict[str, int]:
    """Each wrapper's count."""
    return {name: int(fn.launches) for name, fn in WRAPPERS.items()}


def zero() -> None:
    """Set every count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def since(before: Dict[str, int]) -> Dict[str, int]:
    """The counts added since ``before`` (a ``counts()``)."""
    return {name: n - before[name] for name, n in counts().items()}


def add(deltas: Dict[str, int]) -> None:
    """Add ``deltas`` (kernel name -> launches) to the counts."""
    for name, n in deltas.items():
        WRAPPERS[name].launches += n
