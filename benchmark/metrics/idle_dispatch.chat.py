"""Percent of the profiled window in which the card sat idle inside the
paged engine's ``engine.dispatch`` ranges, the decode step's issue up
to its one blocking fetch (`spans.idle_in`)."""

from benchmark.spans import idle_in


def read(ctx):
    return idle_in(ctx.trace, "engine.dispatch")
