"""Percent of the window's tick time in the engine's admission phase:
each admitted prompt's padded prefill into the paged pool
(`readers.phase_share`)."""

from benchmark.readers import phase_share


def read(ctx):
    return phase_share(ctx, "admit")
