"""Percent of the profiled window in which the card sat idle inside the
rows engine's ``engine.host`` ranges, the token processing after a
decode step's fetch (`spans.idle_in`)."""

from benchmark.spans import idle_in


def read(ctx):
    return idle_in(ctx.trace, "engine.host")
