"""`spans`: the card's idle time inside named host ranges, on synthetic
traces reckoned by hand, and a histogram's mean."""

from __future__ import annotations

import pytest

from benchmark import spans
from benchmark.devtrace import DeviceTrace

WINDOW_S = 0.01  # 10,000 us


def trace(device, host, window_s=WINDOW_S):
    """A `DeviceTrace` from (start_us, end_us[, device]) device operations
    and (name, start_us, end_us[, thread]) host events."""
    return DeviceTrace(
        window_s=window_s,
        device=[("k", a, b - a, rest[0] if rest else 0) for a, b, *rest in device],
        host=[(n, a, b - a, rest[0] if rest else 1) for n, a, b, *rest in host])


# The card busy on [0, 100], [300, 400] and [900, 1000]: idle on
# [100, 300] and [400, 900] inside the events' span [0, 1000].
BUSY = [(0, 100), (300, 400), (900, 1000)]

CASES = {
    # One range over parts of both gaps: 200 + 50 us.
    "one": ([("engine.admit", 50, 450)], 250.0),
    # A range nested in another of the same name counts once.
    "nested": ([("engine.admit", 50, 450), ("engine.admit", 120, 200)], 250.0),
    # Abutting ranges join into [150, 600]: 150 + 200 us of the gaps.
    "abutting": ([("engine.admit", 150, 250), ("engine.admit", 250, 600)], 350.0),
    # Ranges on two threads are one union: [100, 300] whole, [400, 500].
    "threads": ([("engine.admit", 0, 300, 1), ("engine.admit", 250, 500, 2)], 300.0),
    # A range over busy time only reads nothing.
    "busy_only": ([("engine.admit", 310, 390)], 0.0),
    # Other names do not count.
    "other_names": ([("engine.admit", 100, 150), ("engine.host", 150, 300)], 50.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_idle_in_hand_reckoned(case):
    host, want_us = CASES[case]
    got = spans.idle_in(trace(BUSY, host), "engine.admit")
    assert got == pytest.approx(100.0 * want_us * 1e-6 / WINDOW_S)


def test_a_range_opened_more_than_256_host_events_before_a_gap():
    """The range opens, 300 host operations run and close, then the card
    idles: the whole gap is the range's, though no operation is open in
    its middle and the range lies 300 events back."""
    ops = [("aten::mm", 10 + i, 10.5 + i) for i in range(300)]
    t = trace([(0, 400), (600, 700)], [("engine.prefill", 5, 650)] + ops)
    assert spans.idle_in(t, "engine.prefill") == pytest.approx(100.0 * 200e-6 / WINDOW_S)
    assert t.idle_gaps() == [["(no host operation)", pytest.approx(200e-6)]]


def test_disjoint_names_sum_to_at_most_the_idle_share():
    host = [("engine.admit", 0, 350), ("engine.dispatch", 350, 700), ("engine.host", 700, 950)]
    t = trace(BUSY, host)
    parts = [spans.idle_in(t, n) for n in ("engine.admit", "engine.dispatch", "engine.host")]
    idle = 100.0 * (1.0 - t.mean_busy_s() / t.window_s)
    assert sum(parts) == pytest.approx(100.0 * 700e-6 / WINDOW_S)
    assert sum(parts) <= idle


def test_the_mean_over_cards():
    # Card 0 idle on [100, 300] of the span, card 1 idle on [0, 200].
    t = trace([(0, 100, 0), (300, 400, 0), (200, 400, 1)], [("engine.admit", 0, 400)])
    assert spans.idle_in(t, "engine.admit") == pytest.approx(100.0 * 200e-6 / WINDOW_S)


@pytest.mark.parametrize("t", [
    None,
    trace([], [("engine.admit", 0, 10)]),
    trace(BUSY, [("bench.tick", 0, 1000)]),
], ids=["no_trace", "no_device_operation", "no_such_range"])
def test_idle_in_reads_nothing_without_its_inputs(t):
    assert spans.idle_in(t, "engine.admit") is None


def test_mean_ms_of_one_series():
    from tpu_dra_torch.utils.metrics import Histogram

    h = Histogram("x_seconds", "help", buckets=(0.1, 1.0))
    assert spans.mean_ms(h, phase="backward") is None
    for v, phase in ((0.2, "backward"), (0.4, "backward"), (5.0, "forward")):
        h.observe(v, phase=phase)
    assert spans.mean_ms(h, phase="backward") == pytest.approx(300.0)
    assert spans.mean_ms(h, phase="forward") == pytest.approx(5000.0)
    assert spans.mean_ms(h, phase="update") is None
