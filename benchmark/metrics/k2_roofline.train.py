"""K2's share of its roofline, in percent: the causal forward's bound
(the larger of its FLOPs and its q, k, v, o bytes over the peaks) over
the profiled mean time of `flash_fwd_kernel`."""

from benchmark import roofline
from benchmark.readers import K2_KERNEL


def read(ctx):
    if ctx.peak is None or ctx.trace is None:
        return None
    times = ctx.trace.kernel_times(K2_KERNEL)
    if not times:
        return None
    m = ctx.model
    call = roofline.flash_forward_call(ctx.layer["batch"], m["seq"], m["n_heads"],
                                       m["d_model"] // m["n_heads"])
    return 100.0 * roofline.bound_s(*call, ctx.peak) / (sum(times) / len(times))
