"""The serving stack's metrics: a Prometheus text-exposition registry and
the HTTP endpoint that serves it with the engine's debug documents.

Counterpart of `tpu_dra.utils.metrics`, cut to the half a GPU serving host
runs: the metric primitives (`Counter`, `Gauge` with scrape-time
`Gauge.set_function` samplers, `Histogram`, `Registry`), the families the
engine stack writes, with the reference's names, help texts, labels and
buckets, so a scraper reads the same series from either package, and
`MetricsServer` with the routes those families and documents feed:

- ``GET /metrics``                    Prometheus text format;
- ``GET /healthz`` / ``/readyz``      liveness and readiness;
- ``GET /debug/engine``               the step flight recorder
  (`utils.servestats`): ``engine=``, ``limit=``, ``format=json|text``;
- ``GET /debug/kv``                   the paged pools (`obs.kv`);
- ``GET /debug/requests``             request waterfalls and per-class
  aggregates (`obs.requests`): ``engine=``, ``class=``, ``trace_id=``;
- ``GET /debug/capacity``             the engines' busy/idle device
  seconds (`obs.capacity`);
- ``GET /debug/fleet``                the fleet placement recorder
  (`fleet.stats`): ``fleet=``, ``replica=``, ``reason=``, ``limit=``,
  ``format=json|text``;
- ``GET /debug/traces``               finished spans (`utils.trace`):
  ``trace_id=``, ``limit=``, ``format=json|text|raw``.

A bad query answers 400, as the reference's does.  The control plane's
families (allocation, scheduling, the capacity ledger's claims) and its
routes stay with the control plane, which runs no compute.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def _escape_label_value(value: str) -> str:
    """Escape per the Prometheus text-format spec: label values escape
    backslash, double-quote, and line feed."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: "dict[str, str]") -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._values: "dict[tuple, float]" = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        """Current value of one series (bench/test readback — the text
        exposition is for scrapers, not for in-process deltas)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum across every label combination of this counter."""
        with self._lock:
            return sum(self._values.values())

    def collect(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return "\n".join(out)


# Rebound to the real counter once the default registry below exists;
# Gauge.collect reads the global at call time, so the placeholder only
# matters during this module's own import.
METRIC_SAMPLE_ERRORS: "Counter | None" = None


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._values: "dict[tuple, float]" = {}
        self._fns: "dict[tuple, object]" = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = float(value)

    def set_function(self, fn, **labels: str) -> None:
        """Sample a callable at scrape time (e.g. workqueue depth).

        Contract at scrape: a raising callback moves
        ``tpu_dra_metric_sample_errors_total{metric=<this gauge>}`` and the
        series re-exposes its LAST GOOD sample (a broken sampler must not
        silently vanish from the exposition); a callback returning ``None``
        retires the series entirely (the owner is gone — the weakref
        teardown path)."""
        with self._lock:
            self._fns[tuple(sorted(labels.items()))] = fn

    def remove(self, **labels: str) -> None:
        """Retire one labeled series (set() or sampled) — call when the
        labeled entity is deconfigured or a sampler's owner shuts down,
        so the exposition stops carrying a frozen last value (and the
        process-global registry doesn't pin dead object graphs)."""
        self._remove_key(tuple(sorted(labels.items())))

    # Historical name from when only sampled series could be retired.
    remove_function = remove

    def _remove_key(self, key: tuple) -> None:
        with self._lock:
            self._fns.pop(key, None)
            self._values.pop(key, None)

    def collect(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            values = dict(self._values)
            fns = list(self._fns.items())
        sampled: "dict[tuple, float]" = {}
        for key, fn in fns:
            try:
                raw = fn()
                value = None if raw is None else float(raw)
            except Exception:
                # Count the failure and fall through to the stored
                # last-good sample (if any): a broken sampler shows up in
                # sample_errors_total instead of vanishing.
                if METRIC_SAMPLE_ERRORS is not None:
                    METRIC_SAMPLE_ERRORS.inc(metric=self.name)
                continue
            if value is None:
                # The sampler's owner is gone: retire fn + series.
                self._remove_key(key)
                values.pop(key, None)
                continue
            sampled[key] = value
        if sampled:
            values.update(sampled)
            with self._lock:
                # Remember the good samples so a later callback failure
                # re-exposes them instead of dropping the series.
                for key, v in sampled.items():
                    if key in self._fns:  # not retired meanwhile
                        self._values[key] = v
        for key, v in sorted(values.items()) or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return "\n".join(out)


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    def __init__(self, name: str, help_: str, buckets: "tuple[float, ...]" = DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._counts: "dict[tuple, list[int]]" = {}
        self._sums: "dict[tuple, float]" = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            self._sums[key] = self._sums.get(key, 0.0) + value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    return
            counts[-1] += 1

    def time(self, **labels: str):
        """Context manager: observe the elapsed seconds of the block."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)
                return False

        return _Timer()

    def collect(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        for key, counts in items:
            labels = dict(key)
            cumulative = 0
            for bound, c in zip(self.buckets, counts):
                cumulative += c
                le = {**labels, "le": repr(float(bound))}
                out.append(f"{self.name}_bucket{_fmt_labels(le)} {cumulative}")
            cumulative += counts[-1]
            out.append(f'{self.name}_bucket{_fmt_labels({**labels, "le": "+Inf"})} {cumulative}')
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {sums.get(key, 0.0)}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {cumulative}")
        return "\n".join(out)


class Registry:
    def __init__(self):
        self._metrics: "list[object]" = []
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def counter(self, name: str, help_: str) -> Counter:
        return self.register(Counter(name, help_))

    def gauge(self, name: str, help_: str) -> Gauge:
        return self.register(Gauge(name, help_))

    def histogram(self, name: str, help_: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, buckets))

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        return "\n".join(m.collect() for m in metrics) + "\n"


# The process registry: the engine stack's series (each engine moves only
# its own labels).
REGISTRY = Registry()

TRACE_SPANS_TOTAL = REGISTRY.counter(
    "tpu_dra_trace_spans_total",
    "Finished trace spans by span name and OK/ERROR status (utils/trace.py)",
)
SPAN_SECONDS = REGISTRY.histogram(
    "tpu_dra_span_seconds", "Trace span duration by span name"
)
SERVE_PREFIX_HITS = REGISTRY.counter(
    "tpu_dra_serve_prefix_hits_total",
    "Engine admissions that reused a resident shared-prefix KV segment "
    "(suffix-only prefill)",
)
SERVE_PREFIX_MISSES = REGISTRY.counter(
    "tpu_dra_serve_prefix_misses_total",
    "Engine admissions that found no usable resident prefix (full prefill)",
)
SERVE_PREFIX_EVICTIONS = REGISTRY.counter(
    "tpu_dra_serve_prefix_evictions_total",
    "Prefix-pool rows recycled (LRU among unpinned entries) to admit a "
    "new prefix",
)
SERVE_PREFILL_TOKENS = REGISTRY.counter(
    "tpu_dra_serve_prefill_tokens_total",
    "Prompt tokens at admission by kind: computed (ran through prefill) "
    "vs reused (copied from a resident prefix segment)",
)
SERVE_TTFT_SECONDS = REGISTRY.histogram(
    "tpu_dra_serve_ttft_seconds",
    "Serve-engine time to first token per request (submit to first "
    "generated token, queue wait included)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
SERVE_TPOT_SECONDS = REGISTRY.histogram(
    "tpu_dra_serve_tpot_seconds",
    "Serve-engine inter-token latency per generated token after the first "
    "(time-per-output-token; host arrival gaps, steps_per_tick fusion "
    "attributes a fused batch's gap to its first token)",
    buckets=(0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0),
)
SERVE_QUEUE_WAIT_SECONDS = REGISTRY.histogram(
    "tpu_dra_serve_queue_wait_seconds",
    "Serve-engine queue wait per request (submit to admission into a "
    "batch row)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)
SERVE_SLO_TOTAL = REGISTRY.counter(
    "tpu_dra_serve_slo_total",
    "Serve-engine SLO verdicts per finished request: slo is ttft, tpot, "
    "or request (every configured target met), verdict is met or missed",
)
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "tpu_dra_serve_queue_depth",
    "Requests waiting for a batch row, per engine (sampled at scrape)",
)
SERVE_BATCH_OCCUPANCY = REGISTRY.gauge(
    "tpu_dra_serve_batch_occupancy",
    "Batch rows mid-decode, per engine (sampled at scrape; compare with "
    "the engine's slots for utilization)",
)
SERVE_KV_BLOCKS = REGISTRY.gauge(
    "tpu_dra_serve_kv_blocks",
    "Paged KV pool blocks per engine by state: free (allocatable), "
    "allocated (owned by a live block table or a resident prefix "
    "entry; scratch block excluded), aliased (more than one owner — "
    "the shared, immutable fraction), host (swapped out to the "
    "host-tier pool, held by a preempted mid-decode request); sampled "
    "at scrape",
)
SERVE_KV_SWAPS = REGISTRY.counter(
    "tpu_dra_serve_kv_swaps_total",
    "Paged KV blocks moved between HBM and the host swap tier per "
    "engine: direction='out' is a preemption parking a mid-decode "
    "request's blocks to host (a block-table rewrite + bounded DMA, "
    "never a recompute), direction='in' the token-identical restore — "
    "a sustained 'in' rate on a full pool is swap thrash (the "
    "KVSwapThrash alert)",
)
SERVE_KV_ALIAS = REGISTRY.counter(
    "tpu_dra_serve_kv_alias_total",
    "Blocks aliased into a request's block table at admission instead "
    "of being copied or recomputed (a prefix hit's zero-copy reuse, "
    "counted in blocks)",
)
SERVE_WASTED_STEPS = REGISTRY.counter(
    "tpu_dra_serve_wasted_steps_total",
    "Device decode steps executed for a batch row whose request had "
    "already finished earlier in the same fused tick (the surplus token "
    "is discarded host-side) — the tick-granularity overhead that "
    "scheduling='continuous' removes; 0 under continuous batching",
)
SERVE_KV_COW = REGISTRY.counter(
    "tpu_dra_serve_kv_cow_total",
    "Copy-on-write block copies at admission: the partial last prompt "
    "block a parked prefix entry shares with its live request is "
    "privatized so decode writes never touch a shared block",
)
SERVE_STEP_PHASE_SECONDS = REGISTRY.histogram(
    "tpu_dra_serve_step_phase_seconds",
    "Serve-engine tick wall time by phase per engine: admit (placement "
    "+ prefix match + block alloc + admission prefill), dispatch "
    "(decode device-call issue), fetch (the one blocking device_get "
    "per call), host (token processing and finish bookkeeping)",
    buckets=(0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5),
)
SERVE_KV_BLOCK_AGE_SECONDS = REGISTRY.histogram(
    "tpu_dra_serve_kv_block_age_seconds",
    "Residency lifetime of a paged KV block per engine, observed when "
    "its last reference drops and it returns to the free list "
    "(monotonic clock) — long-lived blocks are hot shared prefixes, "
    "short-lived ones decode churn",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
)
SERVE_KV_FREE_RUN_BLOCKS = REGISTRY.histogram(
    "tpu_dra_serve_kv_free_run_blocks",
    "Length in blocks of each contiguous free run in a paged KV pool, "
    "observed per engine on every 8th tick that admitted or finished "
    "requests (the scan is O(pool), so shape-changing ticks are "
    "sampled) — the fragmentation signal: many short runs while free "
    "blocks exist means the pool needs defragmentation",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
SERVE_REQUEST_PHASE_SECONDS = REGISTRY.histogram(
    "tpu_dra_serve_request_phase_seconds",
    "Per-request submit->finish wall time by waterfall phase and "
    "priority class: queue (submit to admission), admit (placement + "
    "prefill to first token), decode (first token to finish, host"
    "-parked and handoff-parked time excluded), handoff (parked "
    "between prefill-tier finish and decode-tier admission in a "
    "disaggregated deployment), preempted-host (parked in the host "
    "swap tier mid-decode), swap-dma (block DMA of the preemption "
    "round trip); the phases tile submit->finish (closure >= 0.95)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)
# Serve-fleet router (fleet/): placements across engine replicas
# by reason, plus the routing-health gauges — digest freshness, load
# balance, and the fleet-level overflow queue.
FLEET_ROUTED = REGISTRY.counter(
    "tpu_dra_fleet_routed_total",
    "Fleet router placements by replica and reason: affinity (digest "
    "match won), load (no match, or the match shed to a colder "
    "replica), spill (digest stale at placement — live verify missed), "
    "random / round_robin (benchmark control policies)",
)
FLEET_ROUTE_TOTAL = REGISTRY.counter(
    "tpu_dra_fleet_route_total",
    "Fleet root spans (fleet.route) opened per routed request by "
    "outcome: affinity, load, spill, random, round_robin — the "
    "trace-side sibling of tpu_dra_fleet_routed_total{replica,reason} "
    "(one increment per request-level trace root, replica-agnostic, so "
    "an outcome-mix dashboard needs no replica fan-in)",
)
FLEET_DIGEST_AGE = REGISTRY.gauge(
    "tpu_dra_fleet_digest_age_seconds",
    "Age of each replica's cached prefix digest at scrape (per fleet "
    "and replica; 0 until first built)",
)
FLEET_LOAD_SKEW = REGISTRY.gauge(
    "tpu_dra_fleet_load_skew",
    "Spread between the most and least loaded replica of a fleet, in "
    "rounds of committed work per batch row ((queue+occupancy)/slots)",
)
FLEET_QUEUE_DEPTH = REGISTRY.gauge(
    "tpu_dra_fleet_queue_depth",
    "Requests parked at fleet level because every replica was at its "
    "admission cap (per fleet, sampled at scrape)",
)
FLEET_SCALE_HINTS = REGISTRY.counter(
    "tpu_dra_fleet_scale_hints_total",
    "ServeFleet.scale_hint() verdicts by hint (grow, shrink, hold)",
)
SERVE_TIER_ENGINES = REGISTRY.gauge(
    "tpu_dra_serve_tier_engines",
    "Engines serving each disaggregation tier, value 1 per live engine "
    "(labels engine + tier: prefill | decode | mono) — the build-info "
    "convention, labels carry the payload; a pre-tier endpoint simply "
    "lacks the series (absent is not zero)",
)
DISAGG_PREFILL_QUEUE_DEPTH = REGISTRY.gauge(
    "tpu_dra_disagg_prefill_queue_depth",
    "Requests waiting for prefill-tier capacity per DisaggServer "
    "(server backlog plus the prefill engines' own queues, sampled at "
    "scrape) — the series PrefillBacklogGrowth differentiates",
)
DISAGG_HANDOFFS = REGISTRY.counter(
    "tpu_dra_disagg_handoffs_total",
    "Prefill->decode KV handoffs completed per decode engine by mode: "
    "alias (refcount alias of the block table into the decode engine's "
    "table — zero device copies) or dma (bounded block stream over the "
    "read_block/write_block primitives through the staging "
    "HostBlockPool)",
)
DISAGG_HANDOFF_BLOCKS = REGISTRY.counter(
    "tpu_dra_disagg_handoff_blocks_total",
    "KV blocks moved prefill->decode per decode engine and handoff "
    "mode (alias | dma)",
)
METRIC_SAMPLE_ERRORS = REGISTRY.counter(
    "tpu_dra_metric_sample_errors_total",
    "Gauge set_function callbacks that raised at scrape time, by metric "
    "name (the series re-exposes its last good sample)",
)
RING_DROPPED = REGISTRY.counter(
    "tpu_dra_ring_dropped_total",
    "Records evicted from bounded telemetry rings by ring name (trace, "
    "decisions, engine, fleet, requests, obs_alerts, capacity)",
)
TRACE_SPANS_DROPPED = REGISTRY.counter(
    "tpu_dra_trace_spans_dropped_total",
    "Finished spans evicted from the in-memory ring exporter by the "
    "capacity bound (utils/trace.py SpanExporter) — a climbing rate "
    "means a busy engine is quietly losing the tail of every trace "
    "before /debug/traces or the cluster collector reads it",
)
# The port's own family (the reference's trainer has none): the burn-in
# trainer's step phases on the device's clock (parallel/burnin.py).
TRAIN_PHASE_DEVICE_SECONDS = REGISTRY.histogram(
    "tpu_dra_train_phase_device_seconds",
    "Burn-in train step time by phase on the device's clock: forward "
    "(the loss), backward (the gradients), update (clip and optimizer); "
    "CUDA events read once done, never waited for (a step whose events "
    "are still pending two steps later is dropped); the host clock on a "
    "CPU device; a trainer's first step (kernel builds) is not observed",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0),
)


# -- the HTTP endpoint ---------------------------------------------------------


class _BadQuery(ValueError):
    """A malformed or out-of-range query parameter: answered with 400."""


def _query_float(query: dict, name: str, default: float, cap: float) -> float:
    raw = query.get(name, [str(default)])[0]
    try:
        value = float(raw)
    except ValueError:
        raise _BadQuery(f"{name} must be a number, got {raw!r}") from None
    if math.isnan(value) or math.isinf(value) or value <= 0:
        raise _BadQuery(f"{name} must be a positive finite number, got {raw!r}")
    return min(value, cap)


def _query_int(query: dict, name: str, default: int, cap: int, minimum: int = 1) -> int:
    raw = query.get(name, [str(default)])[0]
    try:
        value = int(raw)
    except ValueError:
        raise _BadQuery(f"{name} must be an integer, got {raw!r}") from None
    if value < minimum:
        raise _BadQuery(f"{name} must be >= {minimum}, got {raw!r}")
    return min(value, cap)


def _query_format(query: dict, allowed: "tuple[str, ...]") -> str:
    fmt = query.get("format", ["json"])[0]
    if fmt not in allowed:
        if len(allowed) == 2:
            raise _BadQuery(f"format must be json or text, got {fmt!r}")
        raise _BadQuery(f"format must be json, text, or raw, got {fmt!r}")
    return fmt


def _engine_doc(query: dict) -> "tuple[str, object]":
    from tpu_dra_torch.utils import servestats

    limit = _query_int(query, "limit", 256, cap=servestats.RECORDER.capacity)
    fmt = _query_format(query, ("json", "text"))
    records = servestats.RECORDER.query(engine=query.get("engine", [""])[0] or None,
                                        limit=limit)
    if fmt == "text":
        return fmt, servestats.render_text(records)
    return fmt, {
        "steps": [r.to_dict() for r in records],
        "dropped": servestats.RECORDER.dropped,
        "recorded": servestats.RECORDER.recorded,
        "summary": servestats.summarize(records),
    }


def _requests_doc(query: dict) -> "tuple[str, object]":
    from tpu_dra_torch.obs import requests as obsreq

    limit = _query_int(query, "limit", 256, cap=obsreq.RECORDER.capacity)
    fmt = _query_format(query, ("json", "text"))
    cls_raw = query.get("class", [""])[0]
    cls = None
    if cls_raw:
        try:
            cls = int(cls_raw)
        except ValueError:
            raise _BadQuery(f"class must be an integer priority, got {cls_raw!r}") from None
    doc = obsreq.requests_doc(engine=query.get("engine", [""])[0] or None, cls=cls,
                              trace_id=query.get("trace_id", [""])[0] or None, limit=limit)
    return fmt, obsreq.render_text(doc) if fmt == "text" else doc


def _kv_doc(query: dict) -> "tuple[str, object]":
    from tpu_dra_torch.obs import kv as obskv

    limit = _query_int(query, "limit", 256, cap=4096)
    fmt = _query_format(query, ("json", "text"))
    doc = obskv.kv_doc(engine=query.get("engine", [""])[0] or None, limit=limit)
    return fmt, obskv.render_text(doc) if fmt == "text" else doc


def _capacity_doc(query: dict) -> "tuple[str, object]":
    from tpu_dra_torch.obs import capacity as obscap

    limit = _query_int(query, "limit", 256, cap=4096)
    stranded_after = _query_float(query, "stranded_after", obscap.DEFAULT_STRANDED_AFTER_S,
                                  cap=3600.0)
    fmt = _query_format(query, ("json", "text"))
    cls = query.get("class", [""])[0] or None
    if cls is not None and cls not in obscap.CLASSES:
        raise _BadQuery(f"class must be one of {', '.join(obscap.CLASSES)}, got {cls!r}")
    doc = obscap.capacity_doc(limit=limit, stranded_after_s=stranded_after)
    return fmt, obscap.render_text(doc) if fmt == "text" else doc


def _fleet_doc(query: dict) -> "tuple[str, object]":
    from tpu_dra_torch.fleet import stats as fleetstats

    limit = _query_int(query, "limit", 256, cap=fleetstats.RECORDER.capacity)
    fmt = _query_format(query, ("json", "text"))
    records = fleetstats.RECORDER.query(fleet=query.get("fleet", [""])[0] or None,
                                        replica=query.get("replica", [""])[0] or None,
                                        reason=query.get("reason", [""])[0] or None,
                                        limit=limit)
    if fmt == "text":
        return fmt, fleetstats.render_text(records)
    return fmt, {
        "placements": [r.to_dict() for r in records],
        "dropped": fleetstats.RECORDER.dropped,
        "recorded": fleetstats.RECORDER.recorded,
        "summary": fleetstats.summarize(records),
    }


def _traces_doc(query: dict) -> "tuple[str, object]":
    from tpu_dra_torch.utils import trace

    limit = _query_int(query, "limit", 1024, cap=trace.EXPORTER.capacity)
    fmt = _query_format(query, ("json", "text", "raw"))
    records = trace.EXPORTER.spans(trace_id=query.get("trace_id", [""])[0] or None,
                                   limit=limit)
    if fmt == "text":
        return fmt, trace.render_tree(records)
    if fmt == "raw":
        # The exporter's records verbatim, for a collector's join across
        # processes.
        return fmt, {"spans": records, "recorded": trace.EXPORTER.recorded,
                     "dropped": trace.EXPORTER.dropped}
    return fmt, trace.chrome_trace(records)


class MetricsServer:
    """Serve ``/metrics``, health and the engine's debug documents on one
    address (``"host:port"``; port 0 picks a free one, read back from
    `port`), in a daemon thread."""

    def __init__(self, address: str, *, registry: Registry = REGISTRY,
                 metrics_path: str = "/metrics", pprof_path: str = "/debug",
                 ready_check=None):
        host, _, port = address.rpartition(":")
        self.registry = registry
        self.metrics_path = metrics_path
        self.pprof_path = pprof_path.rstrip("/")
        self.ready_check = ready_check or (lambda: True)
        debug = {f"{self.pprof_path}/{name}": fn for name, fn in (
            ("engine", _engine_doc), ("requests", _requests_doc), ("kv", _kv_doc),
            ("capacity", _capacity_doc), ("fleet", _fleet_doc), ("traces", _traces_doc))}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # scrapes are not log events
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                try:
                    if parsed.path == outer.metrics_path:
                        self._send(200, outer.registry.expose(), "text/plain; version=0.0.4")
                    elif parsed.path == "/healthz":
                        self._send(200, "ok\n")
                    elif parsed.path == "/readyz":
                        ready = outer.ready_check()
                        self._send(200 if ready else 503, "ok\n" if ready else "not ready\n")
                    elif parsed.path in debug:
                        fmt, doc = debug[parsed.path](parse_qs(parsed.query))
                        if fmt == "text":
                            self._send(200, doc)
                        else:
                            self._send(200, json.dumps(doc), "application/json")
                    else:
                        self._send(404, "not found\n")
                except _BadQuery as e:
                    self._send(400, f"{e}\n")
                except Exception as e:
                    self._send(500, f"{e}\n")

            def _send(self, code: int, body: str, ctype: str = "text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host or "0.0.0.0", int(port)), Handler)
        self._thread: "threading.Thread | None" = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
