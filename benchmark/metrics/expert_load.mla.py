"""The expert layers' load imbalance over the window: in each expert
layer, the assignments its busiest routed expert took over the mean an
expert took (the engine's device tally, `ServeEngine.moe_assignments`,
read before and after the window), the largest over the layers.  1 is a
perfect balance; a grouped expert product waits on its busiest
expert."""


def read(ctx):
    tally = ctx.layer.get("tally")
    if not tally:
        return None
    ratios = [max(row) * len(row) / sum(row) for row in tally if sum(row)]
    return max(ratios) if ratios else None
