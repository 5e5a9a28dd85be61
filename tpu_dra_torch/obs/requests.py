"""Request latency attribution: the ``/debug/requests`` document.

Counterpart of `tpu_dra.obs.requests`.  A finished request's timeline
(``enqueued_at <= admitted_at <= first_token_at <= finished_at``, and the
swap and handoff windows) folds into six phases that tile submit to
finish (`reduce_request`): ``queue``, ``admit``, ``decode``,
``handoff``, ``preempted-host`` and ``swap-dma``.  The engine pushes
each finished request here (`observe_finished`: a record in the bounded
`RECORDER` ring and ``tpu_dra_serve_request_phase_seconds{engine,phase,
class}``, ``class`` the request's priority) and registers a live
per-class provider (`ServeEngine.request_class_stats`, weakref-backed,
unregistered at ``close()``).  `requests_doc` is the document,
`summarize` its per-class aggregates, `render_text` and
`render_waterfall` its text forms.  This module never imports the
engine.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field

from tpu_dra_torch.utils.metrics import SERVE_REQUEST_PHASE_SECONDS

# ONE nearest-rank percentile for the whole obs plane: /debug/engine
# and /debug/requests must never diverge on what "p95" means.
from tpu_dra_torch.utils.servestats import _pctl

logger = logging.getLogger(__name__)

# The canonical waterfall vocabulary, in render order.  The phases tile
# submit->finish: queue + admit + decode + handoff + preempted-host +
# swap-dma == finished_at - enqueued_at (closure >= 0.95 pinned by
# test — the residue is float rounding, never unattributed wall time).
PHASES = ("queue", "admit", "decode", "handoff", "preempted-host",
          "swap-dma")


@dataclass
class RequestRecord:
    """One finished request's attribution: identity, outcome, phases."""

    seq: int = 0  # recorder-assigned, monotonic per process
    ts_unix: float = 0.0
    engine: str = ""  # the replica that served it (Request.replica)
    request: int = 0  # engine-local request id
    cls: int = 0  # admission priority (the SLO class; "class" in JSON)
    trace_id: str = ""  # joins /debug/traces and the waterfall CLI
    prompt_len: int = 0
    tokens: int = 0
    finish_reason: str = ""
    preemptions: int = 0
    total_s: float = 0.0  # enqueued -> finished wall time
    ttft_s: float = 0.0
    tpot_s: float = 0.0  # 0.0 when fewer than two tokens landed
    slo: str = ""  # "met" | "missed" | "" (engine has no SLO targets)
    phase_s: "dict[str, float]" = field(default_factory=dict)
    closure: float = 0.0  # sum(phase_s) / total_s

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts_unix": self.ts_unix,
            "engine": self.engine,
            "request": self.request,
            "class": self.cls,
            "trace_id": self.trace_id,
            "prompt_len": self.prompt_len,
            "tokens": self.tokens,
            "finish_reason": self.finish_reason,
            "preemptions": self.preemptions,
            "total_s": round(self.total_s, 9),
            "ttft_s": round(self.ttft_s, 9),
            "tpot_s": round(self.tpot_s, 9),
            "slo": self.slo,
            "phase_s": {k: round(v, 9) for k, v in self.phase_s.items()},
            "closure": round(self.closure, 4),
        }


def reduce_request(req) -> "RequestRecord | None":
    """Fold one finished ``Request`` into its phase decomposition;
    ``None`` for a request that has not finished (nothing to tile yet).

    Duck-typed on the ``Request`` timeline fields so the reduction stays
    jax-free and testable with plain objects.  The arithmetic is exact
    by construction: ``decode`` is the first-token→finish window MINUS
    the swapped window (``swapped_s`` covers swap-out start through
    swap-in completion, DMA included), and the swapped window splits
    into ``swap-dma`` (measured DMA seconds) and ``preempted-host`` (the
    remainder — time genuinely parked), so the five phases sum back to
    submit→finish.  Each term is clamped at zero: a clock oddity may
    cost closure, never a negative bar."""
    if not getattr(req, "done", False):
        return None
    enqueued = req.enqueued_at
    total = max(0.0, req.finished_at - enqueued)
    queue = max(0.0, req.admitted_at - enqueued)
    admit = max(0.0, req.first_token_at - req.admitted_at)
    swapped = max(0.0, getattr(req, "swapped_s", 0.0))
    dma = min(max(0.0, getattr(req, "swap_dma_s", 0.0)), swapped)
    hosted = swapped - dma
    # The disaggregated handoff window (parallel/disagg.py): parked
    # between the prefill tier's first token and decode-tier admission.
    # Clamped into the first-token→finish window alongside the swapped
    # window so decode never goes negative on a clock oddity.
    span = max(0.0, req.finished_at - req.first_token_at)
    handoff = min(
        max(0.0, getattr(req, "handoff_s", 0.0)), max(0.0, span - swapped)
    )
    decode = max(0.0, span - swapped - handoff)
    phases = {
        "queue": queue,
        "admit": admit,
        "decode": decode,
        "handoff": handoff,
        "preempted-host": hosted,
        "swap-dma": dma,
    }
    covered = sum(phases.values())
    return RequestRecord(
        engine=getattr(req, "replica", ""),
        request=req.id,
        cls=getattr(req, "priority", 0),
        trace_id=getattr(req, "trace_id", ""),
        prompt_len=len(req.prompt),
        tokens=len(req.tokens),
        finish_reason=req.finish_reason,
        preemptions=getattr(req, "preemptions", 0),
        total_s=total,
        ttft_s=req.ttft_s,
        tpot_s=req.tpot_s,
        slo=getattr(req, "slo", {}).get("request", ""),
        phase_s=phases,
        closure=covered / total if total > 0 else 1.0,
    )


def observe_finished(req) -> "RequestRecord | None":
    """The engine's one call at ``_finish``: reduce, record in the ring,
    and move the per-class phase histogram.  Returns the record (None
    when the request is not actually finished — defensive, recorded
    nothing)."""
    rec = reduce_request(req)
    if rec is None:
        return None
    labels = {"engine": rec.engine, "class": str(rec.cls)}
    for phase, value in rec.phase_s.items():
        if value > 0.0:
            SERVE_REQUEST_PHASE_SECONDS.observe(
                value, phase=phase, **labels
            )
    RECORDER.record(rec)
    return rec


DEFAULT_CAPACITY = 4096


class RequestFlightRecorder:
    """Bounded, lock-protected ring of RequestRecords (the controller
    FlightRecorder contract: eviction at capacity moves ``dropped`` and
    the shared ``tpu_dra_ring_dropped_total{ring="requests"}``)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._records: "collections.deque[RequestRecord]" = (
            collections.deque(maxlen=capacity)
        )
        self._seq = 0
        self._dropped = 0

    def record(self, rec: RequestRecord) -> RequestRecord:
        if not rec.ts_unix:
            # Epoch anchor for display/joins; every duration on the
            # record was perf_counter-measured by the engine.
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

            RING_DROPPED.inc(ring="requests")
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
        cls: "int | None" = None,
        trace_id: "str | None" = None,
        limit: "int | None" = None,
    ) -> "list[RequestRecord]":
        """Oldest-first snapshot, filtered; ``limit`` keeps the most
        recent N after filtering."""
        with self._lock:
            out = list(self._records)
        if engine:
            out = [r for r in out if r.engine == engine]
        if cls is not None:
            out = [r for r in out if r.cls == cls]
        if trace_id:
            out = [r for r in out if r.trace_id == trace_id]
        if limit is not None and limit < len(out):
            out = out[len(out) - limit:]
        return out


# The process-wide recorder, shared like servestats.RECORDER: engines
# write it at _finish, /debug/requests reads it.
RECORDER = RequestFlightRecorder()


# -- live in-flight providers (the obs/kv registration pattern) --------------

_LOCK = threading.Lock()
_PROVIDERS: "dict[str, object]" = {}


def register(name: str, provider) -> None:
    """Register a live per-class occupancy provider under an engine
    name.  The provider is a zero-arg callable returning
    ``{"engine", "classes": {"<cls>": {queued, decoding, swapped}}}``,
    or ``None`` once its owner is gone (auto-unregistered at the next
    read).  Two live engines sharing a name overwrite each other — the
    per-engine gauge discipline, documented on ``ServeEngine``."""
    with _LOCK:
        _PROVIDERS[name] = provider


def unregister(name: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(name, None)


def providers() -> "list[str]":
    with _LOCK:
        return sorted(_PROVIDERS)


def _snapshots(engine: "str | None" = None) -> "list[dict]":
    """Live snapshots from every registered provider (or one engine's).
    A provider returning ``None`` is dropped from the registry; one that
    RAISES is only skipped for this read (logged) — introspection must
    never take the debug server down (the obs/kv contract)."""
    with _LOCK:
        items = sorted(_PROVIDERS.items())
    out: "list[dict]" = []
    dead: "list[tuple[str, object]]" = []
    for name, provider in items:
        if engine and name != engine:
            continue
        try:
            snap = provider()
        except Exception as e:
            logger.debug("request class provider %s failed: %s", name, e)
            continue
        if snap is None:
            dead.append((name, provider))
            continue
        out.append(snap)
    if dead:
        with _LOCK:
            for name, provider in dead:
                # Identity-checked: a NEW engine may have re-registered
                # under the recycled name between our read and this pop.
                if _PROVIDERS.get(name) is provider:
                    del _PROVIDERS[name]
    return out


def in_flight(
    engine: "str | None" = None, cls: "int | None" = None
) -> "dict[str, dict]":
    """Live per-class occupancy merged across registered engines:
    ``{"<cls>": {queued, decoding, swapped, in_flight}}`` — the `tpudra
    top` per-class row's live half (the finished half comes from the
    ring)."""
    merged: "dict[str, dict]" = {}
    for snap in _snapshots(engine):
        for c, counts in (snap.get("classes") or {}).items():
            if cls is not None and str(c) != str(cls):
                continue
            agg = merged.setdefault(
                str(c),
                {"queued": 0, "decoding": 0, "swapped": 0, "in_flight": 0},
            )
            for key in ("queued", "decoding", "swapped"):
                n = int(counts.get(key, 0))
                agg[key] += n
                agg["in_flight"] += n
    return merged


# -- aggregation --------------------------------------------------------------




def summarize(records: "list[RequestRecord]") -> dict:
    """Per-priority-class aggregates over the given records: request
    counts, TTFT/TPOT percentiles, goodput (SLO-configured engines
    only — absent is not zero), preemptions, host-parked seconds, and
    the worst closure.  Classes are JSON-keyed as strings (the document
    travels over HTTP)."""
    if not records:
        return {"requests": 0}
    by_cls: "dict[int, list[RequestRecord]]" = {}
    for r in records:
        by_cls.setdefault(r.cls, []).append(r)
    classes: "dict[str, dict]" = {}
    for cls, recs in sorted(by_cls.items()):
        ttfts = sorted(r.ttft_s for r in recs)
        tpots = sorted(r.tpot_s for r in recs if r.tokens > 1)
        met = sum(1 for r in recs if r.slo == "met")
        missed = sum(1 for r in recs if r.slo == "missed")
        row = {
            "requests": len(recs),
            "ttft_p50_s": round(_pctl(ttfts, 0.5), 6),
            "ttft_p95_s": round(_pctl(ttfts, 0.95), 6),
            "tpot_p50_s": round(_pctl(tpots, 0.5), 6) if tpots else None,
            "tpot_p95_s": round(_pctl(tpots, 0.95), 6) if tpots else None,
            "preemptions": sum(r.preemptions for r in recs),
            "hosted_s": round(
                sum(r.phase_s.get("preempted-host", 0.0) for r in recs), 6
            ),
            "closure_min": round(min(r.closure for r in recs), 4),
            "slo_met": met,
            "slo_missed": missed,
            "goodput": (
                round(met / (met + missed), 3) if met + missed else None
            ),
        }
        classes[str(cls)] = row
    return {
        "requests": len(records),
        "engines": sorted({r.engine for r in records}),
        "classes": classes,
        "closure_min": round(min(r.closure for r in records), 4),
    }


def requests_doc(
    engine: "str | None" = None,
    cls: "int | None" = None,
    trace_id: "str | None" = None,
    limit: int = 256,
) -> dict:
    """The ``/debug/requests`` JSON document (filters mirror the query
    parameters; the renderings below consume exactly this shape)."""
    records = RECORDER.query(
        engine=engine, cls=cls, trace_id=trace_id, limit=limit
    )
    return {
        "requests": [r.to_dict() for r in records],
        "summary": summarize(records),
        "in_flight": in_flight(engine, cls),
        "recorded": RECORDER.recorded,
        "dropped": RECORDER.dropped,
    }


# -- renderings ---------------------------------------------------------------


def _ms(value: "float | None") -> str:
    return "-" if value is None else f"{value * 1e3:.2f}"


def render_text(doc: dict) -> str:
    """Plain-text form of the document (``/debug/requests?format=text``
    and ``tpudra requests`` render this byte-identically): per-class
    aggregate table, live in-flight counts, then one row per finished
    request (newest last)."""
    rows = doc.get("requests", [])
    summary = doc.get("summary", {})
    live = doc.get("in_flight", {})
    if not rows and not live:
        return (
            "no finished requests recorded "
            f"(recorded={doc.get('recorded', 0)}, "
            f"dropped={doc.get('dropped', 0)})\n"
        )
    out: "list[str]" = []
    if rows:
        out.append(
            f"{summary['requests']} finished request(s) across "
            f"{len(summary.get('classes', {}))} class(es) on "
            f"{', '.join(summary.get('engines', []))}, closure min "
            f"{summary.get('closure_min', 0.0):.2f}"
        )
    classes = summary.get("classes", {})
    keys = sorted(
        set(classes) | set(live), key=lambda c: int(c), reverse=True
    )
    if keys:
        out.append(
            f"{'class':>5} {'inflight':>8} {'reqs':>5} {'ttft_p50_ms':>11} "
            f"{'ttft_p95_ms':>11} {'tpot_p95_ms':>11} {'goodput':>7} "
            f"{'preempt':>7} {'hosted_ms':>9}"
        )
        for c in keys:
            agg = classes.get(c, {})
            inflight = live.get(c, {}).get("in_flight", 0)
            goodput = agg.get("goodput")
            out.append(
                f"{c:>5} {inflight:>8} {agg.get('requests', 0):>5} "
                f"{_ms(agg.get('ttft_p50_s')):>11} "
                f"{_ms(agg.get('ttft_p95_s')):>11} "
                f"{_ms(agg.get('tpot_p95_s')):>11} "
                f"{'-' if goodput is None else f'{goodput:.3f}':>7} "
                f"{agg.get('preemptions', 0):>7} "
                f"{_ms(agg.get('hosted_s', 0.0)):>9}"
            )
    if rows:
        out.append(
            f"{'seq':>6} {'engine':<12} {'req':>4} {'cls':>3} {'tok':>4} "
            f"{'total_ms':>9} {'ttft_ms':>8} {'queue':>6} {'admit':>6} "
            f"{'decode':>6} {'hand':>6} {'host':>6} {'dma':>6} "
            f"{'clos':>5} trace"
        )
        for r in rows:
            total = r["total_s"]
            fracs = {
                p: (r["phase_s"].get(p, 0.0) / total if total > 0 else 0.0)
                for p in PHASES
            }
            out.append(
                f"{r['seq']:>6} {r['engine']:<12} {r['request']:>4} "
                f"{r['class']:>3} {r['tokens']:>4} {total * 1e3:>9.2f} "
                f"{r['ttft_s'] * 1e3:>8.2f} {fracs['queue']:>6.0%} "
                f"{fracs['admit']:>6.0%} {fracs['decode']:>6.0%} "
                f"{fracs['handoff']:>6.0%} "
                f"{fracs['preempted-host']:>6.0%} {fracs['swap-dma']:>6.0%} "
                f"{r['closure']:>5.2f} {r['trace_id'][:16]}"
            )
    return "\n".join(out) + "\n"


_BAR_WIDTH = 32


def render_waterfall(doc: dict) -> str:
    """The per-request waterfall (``tpudra waterfall <trace-id>``): one
    block per request in the document, each phase a bar proportional to
    its share of submit→finish.  The swap and handoff phases only print
    when the request was actually preempted or handed off — a clean
    monolithic request reads as three bars, not six."""
    rows = doc.get("requests", [])
    if not rows:
        return (
            "no finished request matches "
            f"(recorded={doc.get('recorded', 0)}, "
            f"dropped={doc.get('dropped', 0)}; waterfalls exist only "
            "for finished requests)\n"
        )
    out: "list[str]" = []
    for r in rows:
        total = r["total_s"]
        out.append(
            f"request {r['request']} on {r['engine']} (class "
            f"{r['class']}, trace {r['trace_id']}): "
            f"{total * 1e3:.2f}ms submit->finish, {r['tokens']} "
            f"token(s) ({r['finish_reason']}"
            + (f", {r['preemptions']} preemption(s)" if r["preemptions"]
               else "")
            + f"), closure {r['closure']:.2f}"
        )
        for phase in PHASES:
            v = r["phase_s"].get(phase, 0.0)
            if v <= 0.0 and phase in ("handoff", "preempted-host",
                                      "swap-dma"):
                continue
            frac = v / total if total > 0 else 0.0
            bar = "#" * max(1 if v > 0 else 0, round(frac * _BAR_WIDTH))
            out.append(
                f"  {phase:<14} {bar:<{_BAR_WIDTH}} {v * 1e3:>9.2f}ms "
                f"{frac:>6.1%}"
            )
    return "\n".join(out) + "\n"
