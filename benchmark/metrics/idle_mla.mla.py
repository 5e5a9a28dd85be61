"""Percent of the profiled window in which the card sat idle inside the
latent-attention model's ``mla.attn`` ranges: each block's attention
half, its projections, latent writes and K3 or the expanded attention,
as the host issues them (`spans.idle_in`)."""

from benchmark.spans import idle_in


def read(ctx):
    return idle_in(ctx.trace, "mla.attn")
