"""Percent of the profiled window in which the card sat idle inside the
rows engine's ``engine.admit`` ranges: each admission's B=1 prefill,
its row insert and the wave's fetch (`spans.idle_in`)."""

from benchmark.spans import idle_in


def read(ctx):
    return idle_in(ctx.trace, "engine.admit")
