"""The serving engine's step flight recorder.

Counterpart of `tpu_dra.utils.servestats`, whole: `PHASES`, the tick's
phase decomposition; `StepRecord`, one engine ``tick()`` (occupancy,
queue depth, admissions and prefix hits, finishes, preemptions and
swap-ins, tokens, the tick's wall time and its phases, the cumulative
SLO verdicts); `EngineFlightRecorder`, a bounded ring of them with a
dropped count, and the process's `RECORDER`, which ``/debug/engine``
reads (`metrics.MetricsServer`); `summarize`, the windowed aggregates,
and `render_text`, the ``format=text`` form, which the reference's
``tpudra serve-stats`` CLI prints the same way.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

# The engine tick's phase decomposition (parallel/serve.py stamps these
# on the monotonic clock): admit = placement + prefix match + block
# alloc + admission prefill; dispatch = decode device-call issue; fetch
# = the one blocking device_get per call; host = token processing and
# finish/park bookkeeping.  The order here is the rendering order.
PHASES = ("admit", "dispatch", "fetch", "host")


@dataclass
class StepRecord:
    """One engine ``tick()``: the between-device-steps control state."""

    seq: int = 0  # recorder-assigned, monotonic per process
    ts_unix: float = 0.0
    engine: str = ""  # ServeEngine.name — one recorder serves many engines
    occupancy: int = 0  # rows mid-decode after this tick's admissions
    slots: int = 0  # the engine's compiled batch width
    queue_depth: int = 0  # requests still waiting after admissions
    admitted: int = 0  # requests admitted this tick
    prefix_hits: int = 0  # of those, admissions that reused a resident prefix
    finished: int = 0  # requests completed this tick
    # KV memory hierarchy (paged engines with a host swap tier): rows
    # preempted to host this tick, and swapped-out requests restored
    # into a row this tick (restores are re-admissions but join no
    # first-token wave, so they are counted apart from `admitted`).
    preempted: int = 0
    swapped_in: int = 0
    tokens: int = 0  # tokens emitted this tick (all rows)
    step_wall_s: float = 0.0  # host wall time of the whole tick
    # Phase decomposition of step_wall_s (PHASES above, seconds each,
    # perf_counter-measured by the engine).  The phases tile the tick:
    # sum(phase_s.values()) / step_wall_s closes to >= 0.95 on any tick
    # that did device work (pinned by test) — the residue is loop
    # control and record construction.
    phase_s: "dict[str, float]" = field(default_factory=dict)
    # Cumulative per-engine SLO verdicts at record time (finished requests
    # with every configured SLO met vs any missed) — cumulative, not
    # per-tick, so goodput survives ring eviction.
    slo_met: int = 0
    slo_missed: int = 0

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts_unix": self.ts_unix,
            "engine": self.engine,
            "occupancy": self.occupancy,
            "slots": self.slots,
            "queue_depth": self.queue_depth,
            "admitted": self.admitted,
            "prefix_hits": self.prefix_hits,
            "finished": self.finished,
            "preempted": self.preempted,
            "swapped_in": self.swapped_in,
            "tokens": self.tokens,
            "step_wall_s": self.step_wall_s,
            "phase_s": {k: round(v, 9) for k, v in self.phase_s.items()},
            "slo_met": self.slo_met,
            "slo_missed": self.slo_missed,
        }


DEFAULT_CAPACITY = 4096


class EngineFlightRecorder:
    """Bounded, lock-protected ring buffer of StepRecords.

    The controller FlightRecorder contract: at capacity the oldest record
    is evicted and ``dropped`` moves, so a consumer can tell a quiet
    engine from a recorder that wrapped."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._records: "collections.deque[StepRecord]" = collections.deque(
            maxlen=capacity
        )
        self._seq = 0
        self._dropped = 0

    def record(self, rec: StepRecord) -> StepRecord:
        if not rec.ts_unix:
            # Epoch anchor for display/joins; durations (step_wall_s)
            # arrive perf_counter-measured by the caller.
            rec.ts_unix = time.time()  # noqa: A201 — display stamp, not a duration
        dropped = False
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            if len(self._records) == self.capacity:
                self._dropped += 1  # append below evicts the oldest
                dropped = True
            self._records.append(rec)
        if dropped:
            from tpu_dra_torch.utils.metrics import RING_DROPPED

            RING_DROPPED.inc(ring="engine")
        return rec

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def recorded(self) -> int:
        """Total records ever recorded (monotonic, survives eviction)."""
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0

    def query(
        self,
        engine: "str | None" = None,
        limit: "int | None" = None,
    ) -> "list[StepRecord]":
        """Oldest-first snapshot, optionally one engine's; ``limit`` keeps
        the most recent N after filtering."""
        with self._lock:
            out = list(self._records)
        if engine:
            out = [r for r in out if r.engine == engine]
        if limit is not None and limit < len(out):
            out = out[len(out) - limit:]
        return out


# The process-wide recorder, shared like trace.EXPORTER and
# decisions.RECORDER: engines write it, /debug/engine reads it.
RECORDER = EngineFlightRecorder()


def _pctl(sorted_vals: "list[float]", q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


def summarize(records: "list[StepRecord]") -> dict:
    """Windowed aggregates over the given records (one engine's, or the
    mixed stream): utilization, throughput, step-time percentiles, and
    goodput from the latest cumulative SLO counts per engine."""
    if not records:
        return {"ticks": 0}
    walls = sorted(r.step_wall_s for r in records)
    tokens = sum(r.tokens for r in records)
    wall = sum(walls)
    # Cumulative SLO counts: the LAST record per engine carries the
    # engine's running totals.
    last_per_engine: "dict[str, StepRecord]" = {}
    for r in records:
        last_per_engine[r.engine] = r
    met = sum(r.slo_met for r in last_per_engine.values())
    missed = sum(r.slo_missed for r in last_per_engine.values())
    out = {
        "ticks": len(records),
        "engines": sorted(last_per_engine),
        "admitted": sum(r.admitted for r in records),
        "prefix_hits": sum(r.prefix_hits for r in records),
        "finished": sum(r.finished for r in records),
        "preempted": sum(r.preempted for r in records),
        "swapped_in": sum(r.swapped_in for r in records),
        "tokens": tokens,
        "tokens_per_s": round(tokens / wall, 1) if wall > 0 else 0.0,
        "occupancy_mean": round(
            sum(r.occupancy for r in records) / len(records), 2
        ),
        "queue_depth_max": max(r.queue_depth for r in records),
        "step_wall_p50_s": round(_pctl(walls, 0.5), 6),
        "step_wall_p95_s": round(_pctl(walls, 0.95), 6),
        "slo_met": met,
        "slo_missed": missed,
    }
    # Phase summary over the ticks that carry a decomposition (older
    # records and telemetry-off engines record none — absent, not zero):
    # per-phase p50/p95 plus its fraction of total recorded wall time,
    # so one snapshot answers "where do my steps go?".
    phased = [r for r in records if r.phase_s]
    if phased:
        phased_wall = sum(r.step_wall_s for r in phased)
        phases: "dict[str, dict]" = {}
        for p in PHASES:
            vals = sorted(r.phase_s.get(p, 0.0) for r in phased)
            total = sum(vals)
            phases[p] = {
                "p50_s": round(_pctl(vals, 0.5), 6),
                "p95_s": round(_pctl(vals, 0.95), 6),
                "fraction": round(total / phased_wall, 3)
                if phased_wall > 0
                else 0.0,
            }
        out["phases"] = phases
    if met + missed:
        out["goodput"] = round(met / (met + missed), 3)
    return out


def dominant_phase(phases: "dict[str, dict]") -> "tuple[str, float]":
    """The phase owning the largest fraction of step wall time (from a
    `summarize` ``phases`` dict) — the one-cell answer ``tpudra top``
    and the text render show.  Returns ``(name, fraction)``."""
    best = max(PHASES, key=lambda p: phases.get(p, {}).get("fraction", 0.0))
    return best, phases.get(best, {}).get("fraction", 0.0)


def render_text(records: "list[StepRecord]") -> str:
    """Plain-text snapshot: the summary line plus one row per tick,
    newest last (the ``format=text`` form of ``/debug/engine``)."""
    if not records:
        return "no engine steps recorded\n"
    s = summarize(records)
    head = (
        f"{s['ticks']} tick(s), {s['admitted']} admitted "
        f"({s['prefix_hits']} prefix hit(s)), {s['finished']} finished, "
    )
    if s.get("preempted") or s.get("swapped_in"):
        head += (
            f"{s['preempted']} preempted / {s['swapped_in']} swapped "
            "back in, "
        )
    head += (
        f"{s['tokens']} token(s) @ {s['tokens_per_s']}/s, "
        f"occupancy mean {s['occupancy_mean']}, "
        f"queue max {s['queue_depth_max']}, "
        f"step p50 {s['step_wall_p50_s'] * 1e3:.2f}ms "
        f"p95 {s['step_wall_p95_s'] * 1e3:.2f}ms"
    )
    if "goodput" in s:
        head += (
            f", goodput {s['goodput']} "
            f"({s['slo_met']} met / {s['slo_missed']} missed)"
        )
    out = [head]
    if "phases" in s:
        dom, frac = dominant_phase(s["phases"])
        out.append(
            "phases: "
            + "  ".join(
                f"{p} {s['phases'][p]['fraction']:.0%} "
                f"(p50 {s['phases'][p]['p50_s'] * 1e3:.2f}ms "
                f"p95 {s['phases'][p]['p95_s'] * 1e3:.2f}ms)"
                for p in PHASES
            )
            + f" — dominant: {dom} {frac:.0%}"
        )
    out.append(
        f"{'seq':>6} {'engine':<12} {'occ':>5} {'queue':>5} {'adm':>4} "
        f"{'hit':>4} {'fin':>4} {'tok':>5} {'wall_ms':>8} {'phase':>12}"
    )
    for r in records:
        if r.phase_s:
            p, v = max(r.phase_s.items(), key=lambda kv: kv[1])
            frac = v / r.step_wall_s if r.step_wall_s > 0 else 0.0
            phase = f"{p} {frac:.0%}"
        else:
            phase = "-"
        out.append(
            f"{r.seq:>6} {r.engine:<12} {r.occupancy:>3}/{r.slots:<1} "
            f"{r.queue_depth:>5} {r.admitted:>4} {r.prefix_hits:>4} "
            f"{r.finished:>4} {r.tokens:>5} {r.step_wall_s * 1e3:>8.2f} "
            f"{phase:>12}"
        )
    return "\n".join(out) + "\n"
