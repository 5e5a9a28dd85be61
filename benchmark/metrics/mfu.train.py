"""Model FLOPs of a training step (causal attention at half, recompute
not counted) over the card's bf16 peak, over the window's mean step
wall, in percent."""

from benchmark import roofline


def read(ctx):
    walls = ctx.layer.get("step_walls_s", [])
    if ctx.peak is None or not walls:
        return None
    flops = roofline.train_step_flops(ctx.model, ctx.layer["batch"])
    return 100.0 * flops / ctx.peak.bf16_flops / (sum(walls) / len(walls))
