"""Percent of the profiled window in which the card sat idle inside the
top-k expert layer's ranges (``moe.route``, ``moe.experts``,
``moe.shared``, ``moe.combine`` where the layer runs op by op, and
``moe.layer`` where a captured expert half replays, taken together): the
union of those ranges intersected with the card's idle intervals, the
mean over the cards, as `spans.idle_in` does for one name."""

from benchmark.devtrace import _union
from benchmark.spans import _overlap, idle_intervals

NAMES = ("moe.route", "moe.experts", "moe.shared", "moe.combine", "moe.layer")


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    ranges = _union(sorted((s, s + d) for n, s, d, _ in trace.host if n in NAMES))
    if not ranges:
        return None
    devices = trace.devices()
    idle_us = sum(_overlap(idle_intervals(trace, dev), ranges) for dev in devices) / len(devices)
    return 100.0 * idle_us * 1e-6 / trace.window_s
