"""Percent of the profiled window in which no operation ran on the card
(`readers.device_idle`)."""

from benchmark.readers import device_idle


def read(ctx):
    return device_idle(ctx)
