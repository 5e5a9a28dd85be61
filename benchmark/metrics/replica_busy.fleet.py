"""Percent of the window that a replica's thread spends inside its own
engine's ticks, the mean over the replicas: the window's difference of
each replica's `SERVE_STEP_PHASE_SECONDS` sums (admit, dispatch, fetch,
host) over the window's seconds.  The rest of the window the thread
waits for the fleet's tick barrier (the slowest replica) and for the
driver's Python between ticks."""


def read(ctx):
    phases = ctx.layer.get("replica_phase_s")
    window = ctx.layer.get("window_s")
    if not phases or not window:
        return None
    return 100.0 * sum(sum(p.values()) for p in phases.values()) / (len(phases) * window)
