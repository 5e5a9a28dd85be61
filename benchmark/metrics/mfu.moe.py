"""The rows engine's whole serving loop over the MoE model as a share of
the card's roofline, in percent (`readers.serve_mfu`: every expert's
weights read each step)."""

from benchmark.readers import serve_mfu


def read(ctx):
    return serve_mfu(ctx)
