"""The latent-attention model's whole serving loop as a share of the
card's roofline, in percent, defined as `mfu.chat` is: over every tick
of the window, the least time its device calls could take (each
admission prefill of its real prompt tokens, then the decode step of its
live rows, each the larger of its FLOP and byte bounds,
`mla_roofline`) over the ticks' wall time."""

from benchmark import mla_roofline, roofline


def read(ctx):
    peak, m = ctx.peak, ctx.model
    ticks = ctx.layer.get("ticks", [])
    if peak is None or not ticks or "contexts" not in ticks[0]:
        return None
    bound = wall = 0.0
    for t in ticks:
        for n in t["admitted"]:
            bound += roofline.bound_s(*mla_roofline.prefill(m, n), peak)
        if t["contexts"]:
            bound += roofline.bound_s(*mla_roofline.decode_step(m, t["contexts"]), peak)
        wall += t["end"] - t["start"]
    return 100.0 * bound / wall
