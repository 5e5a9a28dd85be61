"""Fleet placement flight recorder: why did a request land there?

Counterpart of `tpu_dra.fleet.stats`, whole:

- ``PlacementRecord``: one routed request: replica, reason (affinity |
  load | spill | random | round_robin), the digest-claimed match length,
  the digest's age, the loads the router saw and the fleet queue's depth
  at placement.
- ``FleetFlightRecorder``: a bounded ring of them with a dropped count
  (evictions also move ``RING_DROPPED{ring="fleet"}``); the process's
  ``RECORDER``, written by every `ServeFleet` and read by
  ``/debug/fleet`` (`utils.metrics.MetricsServer`).
- ``summarize``: placements by replica and by reason, the affinity
  rate, matched-token stats and the load skew the last placement of each
  fleet saw; ``render_text``, the ``format=text`` form, which the
  reference's ``tpudra fleet-stats`` CLI prints the same way.

Plain Python: ``/debug/fleet`` serves from any process without the
compute stack.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field


@dataclass
class PlacementRecord:
    """One routed request: the router's verdict plus what it saw."""

    seq: int = 0  # recorder-assigned, monotonic per process
    ts_unix: float = 0.0
    fleet: str = ""  # ServeFleet.name — one recorder serves many fleets
    request: int = 0  # fleet-wide request id
    replica: str = ""  # where it landed (ServeEngine.name)
    reason: str = ""  # affinity | load | spill | random | round_robin
    matched: int = 0  # digest-claimed resident prefix tokens
    load: float = 0.0  # chosen replica's load at placement
    digest_age_s: float = 0.0
    queue_depth: int = 0  # fleet-level queue length at placement
    loads: "dict[str, float]" = field(default_factory=dict)
    # The request's fleet-wide trace id (the fleet.route root span's
    # identity): /debug/fleet rows and /debug/traces join on it, so a
    # placement record resolves to the full request waterfall.
    trace_id: str = ""

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts_unix": self.ts_unix,
            "fleet": self.fleet,
            "request": self.request,
            "replica": self.replica,
            "reason": self.reason,
            "matched": self.matched,
            "load": self.load,
            "digest_age_s": self.digest_age_s,
            "queue_depth": self.queue_depth,
            "loads": dict(self.loads),
            "trace_id": self.trace_id,
        }


DEFAULT_CAPACITY = 4096


class FleetFlightRecorder:
    """Bounded, lock-protected ring of PlacementRecords (the controller
    FlightRecorder contract: eviction at capacity moves ``dropped`` so a
    quiet fleet is distinguishable from a wrapped recorder)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._records: "collections.deque[PlacementRecord]" = (
            collections.deque(maxlen=capacity)
        )
        self._seq = 0
        self._dropped = 0

    def record(self, rec: PlacementRecord) -> PlacementRecord:
        if not rec.ts_unix:
            # Epoch anchor for display/joins; ages on the record were
            # measured monotonic by the router.
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

            RING_DROPPED.inc(ring="fleet")
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
        fleet: "str | None" = None,
        replica: "str | None" = None,
        reason: "str | None" = None,
        limit: "int | None" = None,
    ) -> "list[PlacementRecord]":
        """Oldest-first snapshot, filtered; ``limit`` keeps the most
        recent N after filtering."""
        with self._lock:
            out = list(self._records)
        if fleet:
            out = [r for r in out if r.fleet == fleet]
        if replica:
            out = [r for r in out if r.replica == replica]
        if reason:
            out = [r for r in out if r.reason == reason]
        if limit is not None and limit < len(out):
            out = out[len(out) - limit:]
        return out


# The process-wide recorder, shared like servestats.RECORDER: fleets
# write it, /debug/fleet reads it.
RECORDER = FleetFlightRecorder()


def summarize(records: "list[PlacementRecord]") -> dict:
    """Aggregates over the given records: per-replica placement counts,
    reason breakdown, affinity rate, matched-token stats, and the load
    skew the LAST placement saw per fleet."""
    if not records:
        return {"placements": 0}
    by_replica: "dict[str, int]" = {}
    by_reason: "dict[str, int]" = {}
    matched = []
    for r in records:
        by_replica[r.replica] = by_replica.get(r.replica, 0) + 1
        by_reason[r.reason] = by_reason.get(r.reason, 0) + 1
        if r.matched > 0:
            matched.append(r.matched)
    affinity = by_reason.get("affinity", 0)
    last_per_fleet: "dict[str, PlacementRecord]" = {}
    for r in records:
        last_per_fleet[r.fleet] = r
    skews = {
        f: round(max(r.loads.values()) - min(r.loads.values()), 4)
        for f, r in last_per_fleet.items()
        if r.loads
    }
    out = {
        "placements": len(records),
        "fleets": sorted(last_per_fleet),
        "by_replica": dict(sorted(by_replica.items())),
        "by_reason": dict(sorted(by_reason.items())),
        "affinity_rate": round(affinity / len(records), 3),
        "queue_depth_max": max(r.queue_depth for r in records),
        "load_skew_last": skews,
    }
    if matched:
        out["matched_mean"] = round(sum(matched) / len(matched), 1)
        out["matched_max"] = max(matched)
    return out


def render_text(records: "list[PlacementRecord]") -> str:
    """Plain-text snapshot: summary line + one row per placement, newest
    last (the ``format=text`` form of ``/debug/fleet``)."""
    if not records:
        return "no fleet placements recorded\n"
    s = summarize(records)
    reasons = ", ".join(
        f"{n} {k}" for k, n in sorted(s["by_reason"].items())
    )
    replicas = ", ".join(
        f"{k}: {n}" for k, n in sorted(s["by_replica"].items())
    )
    head = (
        f"{s['placements']} placement(s) ({reasons}), affinity rate "
        f"{s['affinity_rate']}, per replica: {replicas}, fleet queue "
        f"max {s['queue_depth_max']}"
    )
    out = [head]
    out.append(
        f"{'seq':>6} {'request':>7} {'replica':<12} {'reason':<11} "
        f"{'match':>5} {'load':>6} {'age_s':>6} {'queue':>5}"
    )
    for r in records:
        out.append(
            f"{r.seq:>6} {r.request:>7} {r.replica:<12} {r.reason:<11} "
            f"{r.matched:>5} {r.load:>6.2f} {r.digest_age_s:>6.2f} "
            f"{r.queue_depth:>5}"
        )
    return "\n".join(out) + "\n"
