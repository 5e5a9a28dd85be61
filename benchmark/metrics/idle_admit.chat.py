"""Percent of the profiled window in which the card sat idle inside the
paged engine's ``engine.admit`` ranges: admissions' prefills, block
bookkeeping and the wave's first-token fetch (`spans.idle_in`)."""

from benchmark.spans import idle_in


def read(ctx):
    return idle_in(ctx.trace, "engine.admit")
