"""Percent of the profiled window in which no operation ran on a card,
the mean over the fleet's cards (`readers.device_idle`)."""

from benchmark.readers import device_idle


def read(ctx):
    return device_idle(ctx)
