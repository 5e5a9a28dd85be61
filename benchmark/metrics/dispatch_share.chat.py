"""Percent of the window's tick time in the engine's dispatch phase
(`readers.phase_share`)."""

from benchmark.readers import phase_share


def read(ctx):
    return phase_share(ctx, "dispatch")
