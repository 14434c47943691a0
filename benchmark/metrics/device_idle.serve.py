"""Percent of the traced serve window in which no kernel, memcpy or
memset ran on the card."""

from benchmark.readers import device_idle


def read(ctx):
    return device_idle(ctx)
