"""Arithmetic the per-layer readers share (each reader is its own file
under ``metrics/``)."""

from __future__ import annotations

from benchmark import roofline, traffic as tr

K1_KERNEL = "paged_attention_kernel"
K2_KERNEL = "flash_fwd_kernel"


def serve_mfu(ctx) -> "float | None":
    """The serving loop's share of the card's roofline, in percent: over
    every tick of the window, the least time its device calls could take
    (each admission prefill of its real prompt tokens, then the decode
    step of its live rows, each the larger of its FLOP and byte bounds)
    over the ticks' wall time."""
    peak, m = ctx.peak, ctx.model
    ticks = ctx.layer.get("ticks", [])
    if peak is None or not ticks or "contexts" not in ticks[0]:
        return None
    bound = wall = 0.0
    for t in ticks:
        for n in t["admitted"]:
            bound += roofline.bound_s(*roofline.prefill(m, n), peak)
        if t["contexts"]:
            bound += roofline.bound_s(*roofline.decode_step(m, t["contexts"]), peak)
        wall += t["end"] - t["start"]
    return 100.0 * bound / wall


def phase_share(ctx, phase: str) -> "float | None":
    """Percent of the window's tick time in one of the engine's phases
    (``admit``, ``dispatch``, ``fetch``, ``host``): the window's
    difference of that phase's `SERVE_STEP_PHASE_SECONDS` sum over the
    ticks' summed wall time."""
    ticks = ctx.layer.get("ticks", [])
    wall = sum(t["end"] - t["start"] for t in ticks)
    spent = ctx.layer.get("phase_s", {}).get(phase)
    if not wall or spent is None:
        return None
    return 100.0 * spent / wall


def device_idle(ctx) -> "float | None":
    """Percent of the profiled window in which no operation ran on the
    device, the mean over the cards the run uses."""
    trace = ctx.trace
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.mean_busy_s() / trace.window_s)


def p95_ms(values_s) -> "float | None":
    return tr.percentile(values_s, 95) * 1e3 if len(values_s) else None
