"""Percent of the profiled window in which the card sat idle inside the
paged engine's ``engine.prefill`` ranges, each admission's padded
prefill call, a part of ``engine.admit`` (`spans.idle_in`)."""

from benchmark.spans import idle_in


def read(ctx):
    return idle_in(ctx.trace, "engine.prefill")
