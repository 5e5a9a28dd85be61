"""The paged engine's whole serving loop as a share of the card's
roofline, in percent (`readers.serve_mfu`)."""

from benchmark.readers import serve_mfu


def read(ctx):
    return serve_mfu(ctx)
