"""K1's share of its roofline, in percent: over the profiled ticks, the
least time K1's launches could take (each live row's context K and V
read once, q read and out written, one launch a layer) over the profiled
time of `paged_attention_kernel`."""

from benchmark import roofline
from benchmark.readers import K1_KERNEL


def read(ctx):
    peak, trace, m = ctx.peak, ctx.trace, ctx.model
    if peak is None or trace is None:
        return None
    spent = sum(trace.kernel_times(K1_KERNEL))
    ticks = [t for t in ctx.layer.get("ticks", []) if t["profiled"] and t.get("contexts")]
    if not spent or not ticks:
        return None
    bound = sum(roofline.bound_s(*roofline.paged_attention_call(m, t["contexts"]), peak)
                for t in ticks) * m["n_layers"]
    return 100.0 * bound / spent
