"""The serve step's model FLOPs over the window, as a share of the H100's
989 TFLOP/s dense bf16 peak (counts.py)."""

from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx)
