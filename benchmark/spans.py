"""Readings of the program's own profiler ranges and phase histogram.

`idle_in` charges the card's idle time to what the host was doing: the
gaps between the union of device operations, inside the span of the
profiled trace's events, intersected with the union of the host ranges
of one name (every thread), in percent of the window, the mean over the
cards.  Ranges are intersected whole, by name, however many host
operations ran inside them before a gap (`devtrace.DeviceTrace.idle_gaps`
looks back a bounded number of events from a gap's middle).  The union
charges each idle microsecond once, so nested or abutting ranges of one
name count once, the metrics of disjoint names sum to at most the idle
share, and a name nested in another reads at most the outer name's.

`mean_ms` is a histogram's mean observation, in ms, read from its
exposition text.
"""

from __future__ import annotations

from benchmark.devtrace import _union


def _overlap(a, b) -> float:
    """Total length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace, device: int) -> "list[list[float]]":
    """The device's idle intervals (microseconds) inside the span of the
    trace's host and device events."""
    events = trace.host + trace.device
    lo = min(s for _, s, _, _ in events)
    hi = max(s + d for _, s, d, _ in events)
    out, at = [], lo
    for a, b in _union(trace._intervals(device)):
        if a > at:
            out.append([at, a])
        at = max(at, b)
    if hi > at:
        out.append([at, hi])
    return out


def idle_in(trace, name: str) -> "float | None":
    """Percent of the profiled window in which the card was idle inside
    a host range named ``name``; None without device operations or
    without such a range."""
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    ranges = _union(sorted((s, s + d) for n, s, d, _ in trace.host if n == name))
    if not ranges:
        return None
    devices = trace.devices()
    idle_us = sum(_overlap(idle_intervals(trace, dev), ranges) for dev in devices) / len(devices)
    return 100.0 * idle_us * 1e-6 / trace.window_s


def mean_ms(hist, **labels) -> "float | None":
    """The mean observation of ``hist``'s series with ``labels``, in ms
    (its sum over its count, read from its exposition text); None where
    the series holds nothing."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    total = count = None
    for line in hist.collect().splitlines():
        if not all(w in line for w in want):
            continue
        if line.startswith(hist.name + "_sum{"):
            total = float(line.rsplit(" ", 1)[1])
        elif line.startswith(hist.name + "_count{"):
            count = float(line.rsplit(" ", 1)[1])
    if not count or total is None:
        return None
    return 1e3 * total / count
