"""Percent of the profiled window in which no operation ran on the card
(`readers.device_idle`: the union of device operations over the window,
not over the kernels' span)."""

from benchmark.readers import device_idle


def read(ctx):
    return device_idle(ctx)
