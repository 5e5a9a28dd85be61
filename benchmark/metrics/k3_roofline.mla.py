"""K3's share of its roofline, in percent: over the profiled ticks, the
least time K3's launches could take (each live row's latent context read
once, its query read and ``o_lat`` written, one launch a layer;
`mla_roofline.k3_call`) over the profiled time of the Triton kernel
`_mla_decode_kernel`."""

from benchmark import mla_roofline, roofline

K3_KERNEL = "_mla_decode_kernel"


def read(ctx):
    peak, trace, m = ctx.peak, ctx.trace, ctx.model
    if peak is None or trace is None:
        return None
    spent = sum(trace.kernel_times(K3_KERNEL))
    ticks = [t for t in ctx.layer.get("ticks", []) if t["profiled"] and t.get("contexts")]
    if not spent or not ticks:
        return None
    bound = sum(roofline.bound_s(*mla_roofline.k3_call(m, t["contexts"]), peak)
                for t in ticks) * m["num_hidden_layers"]
    return 100.0 * bound / spent
