"""Request tracing: W3C-traceparent identities, spans, the process's
ring of finished spans, and profiler ranges.

Counterpart of `tpu_dra.utils.trace`, without the claim-lifecycle
annotation helpers, the JSON log formatter and the ambient ``with
span(...)`` machinery, which belong to the control plane:

- `TraceContext`: a 32-hex trace id, a 16-hex span id and flags,
  serialized as ``00-<trace_id>-<span_id>-<flags>``;
- `emit_span`, a span whose boundaries were measured before (the
  serving engine's queue span runs from ``submit`` to an admission many
  ticks later);
- `SpanExporter`, a bounded ring of finished span records, and the
  process's `EXPORTER`, which ``/debug/traces`` reads
  (`metrics.MetricsServer`) as Chrome-trace JSON or a text tree;
- `range`, a named range on `torch.profiler`'s clock while a profiler
  collects (and nothing otherwise): the engine's and the trainer's
  phases beside the kernels they launch.

Every finished span moves ``tpu_dra_trace_spans_total`` and
``tpu_dra_span_seconds``, the reference's series.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
from dataclasses import dataclass

import torch

TRACEPARENT_VERSION = "00"


# -- trace context (W3C traceparent) -----------------------------------------


def _rand_hex(nbytes: int) -> str:
    value = os.urandom(nbytes).hex()
    if set(value) == {"0"}:  # all-zero ids are invalid per W3C
        return _rand_hex(nbytes)
    return value


@dataclass(frozen=True)
class TraceContext:
    """Identity of one span within one trace."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    flags: str = "01"  # sampled

    def to_traceparent(self) -> str:
        return f"{TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-{self.flags}"

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(trace_id=_rand_hex(16), span_id=_rand_hex(8))

    def child(self) -> "TraceContext":
        return TraceContext(
            trace_id=self.trace_id, span_id=_rand_hex(8), flags=self.flags
        )


# Strict lowercase-hex runs only: int(s, 16) would admit underscores, sign
# prefixes, and whitespace, none of which are valid traceparent bytes.
_HEX_RE = re.compile(r"[0-9a-f]+\Z")


def _is_hex(s: str) -> bool:
    return _HEX_RE.match(s) is not None


def parse_traceparent(value: str) -> "TraceContext | None":
    """Parse a traceparent string; None on any malformation (callers always
    have the fallback of starting a fresh trace)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or set(trace_id) == {"0"}:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or set(span_id) == {"0"}:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id, flags=flags)


# -- components --------------------------------------------------------------

# Which binary this process is ("controller", "plugin", ...); stamps spans so
# the Chrome trace viewer groups them into per-component tracks even when a
# trace crosses processes.  The in-process SimCluster leaves it at the
# default and relies on span-name prefixes instead.
_COMPONENT = "tpu-dra"


def set_component(name: str) -> None:
    global _COMPONENT
    _COMPONENT = name


def unix_of(perf_t: float) -> float:
    """Map a ``perf_counter`` timestamp onto the wall clock for span
    records: timelines run on the monotonic clock, chrome-trace wants
    unix time, and debug-grade precision is fine.  The one conversion
    every retro-span emitter (serve engine, fleet router) shares — a
    drift between two private copies would skew one component's spans
    against the rest of the same trace."""
    return time.time() - (time.perf_counter() - perf_t)  # noqa: A201 — epoch anchor


# -- spans --------------------------------------------------------------------


def emit_span(
    name: str,
    *,
    start_unix_s: float,
    duration_s: float,
    context: "TraceContext | None" = None,
    parent: "TraceContext | None" = None,
    exporter: "SpanExporter | None" = None,
    status: str = "OK",
    status_message: str = "",
    events: "list[dict] | None" = None,
    **attributes,
) -> TraceContext:
    """Export a RETROACTIVELY-timed span — measured boundaries, no ``with``
    block.

    The serve engine needs this shape: a request's queue span runs from
    ``submit()`` to its admission many ``tick()`` calls later, across
    other requests' work — there is no lexical block to wrap, only two
    timestamps the engine already holds.  ``context`` fixes the span's own
    identity (pass the request's root TraceContext to make this span the
    trace root); ``parent`` sets the parent pointer — combine BOTH to
    emit a span whose identity was minted earlier (the fleet router's
    per-request context, handed down so the engine's spans parent under
    it) while still nesting it under an outer span.  With only
    ``parent`` the span is a fresh child; with neither, a fresh trace
    root.  ``events`` attaches timestamped span events (dicts with
    ``name``/``offset_s``/``attributes``): a re-route decision inside a routing span is an event on
    that span, never a fresh trace.  Returns the span's context so
    callers can parent further spans under it.

    The record lands in the ring exporter and moves the span
    counter/duration metrics."""
    if context is not None:
        ctx = context
        parent_id = parent.span_id if parent is not None else ""
    elif parent is not None:
        ctx, parent_id = parent.child(), parent.span_id
    else:
        ctx, parent_id = TraceContext.new(), ""
    record = {
        "name": name,
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id,
        "parent_id": parent_id,
        "component": _COMPONENT,
        "thread": threading.current_thread().name,
        "start_unix_s": start_unix_s,
        "duration_s": duration_s,
        "status": status,
        "status_message": status_message,
        "attributes": {k: v for k, v in attributes.items() if v is not None},
        "events": [dict(e) for e in (events or ())],
    }
    (exporter or EXPORTER).export(record)
    from tpu_dra_torch.utils.metrics import SPAN_SECONDS, TRACE_SPANS_TOTAL

    TRACE_SPANS_TOTAL.inc(name=name, status=status)
    SPAN_SECONDS.observe(duration_s, name=name)
    return ctx


# -- profiler ranges ------------------------------------------------------------

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled  # this thread's profiler is collecting


def range(name: str):  # shadows the builtin in this module, which uses none
    """A context manager that marks ``name`` on the profiler's clock:
    `torch.profiler.record_function` while a `torch.profiler` collects
    on this thread (the range lands in its trace as a ``user_annotation``
    event, beside the kernels its work launched), else one shared
    `contextlib.nullcontext`.  Off, the cost is one check and no
    allocation; an ungated ``record_function`` costs tens of times more
    even with no profiler running."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


# -- exporter -----------------------------------------------------------------

DEFAULT_CAPACITY = 4096


class SpanExporter:
    """Lock-protected in-memory ring buffer of finished span records.

    Bounded so a long-lived process can't grow without limit; the debug
    endpoint is for "what just happened", not long-term storage."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: "list[dict]" = []
        self._exported = 0
        self._dropped = 0

    def export(self, record: dict) -> None:
        overflow = 0
        with self._lock:
            self._spans.append(record)
            self._exported += 1
            if len(self._spans) > self.capacity:
                overflow = len(self._spans) - self.capacity
                del self._spans[:overflow]
                self._dropped += overflow
        if overflow:
            # Lazy import, matching emit_span: the metrics module
            # must not couple to this one at load time.  The dedicated
            # spans-dropped counter is the trace plane's own loss signal
            # (RING_DROPPED is the shared cross-ring form): a busy
            # engine overwriting the tail of every trace was previously
            # silent to anything watching only trace-shaped series.
            from tpu_dra_torch.utils.metrics import RING_DROPPED, TRACE_SPANS_DROPPED

            RING_DROPPED.inc(overflow, ring="trace")
            TRACE_SPANS_DROPPED.inc(overflow)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring bound (the wrapped-buffer tell)."""
        with self._lock:
            return self._dropped

    @property
    def recorded(self) -> int:
        """Total spans ever exported (monotonic, survives eviction)."""
        with self._lock:
            return self._exported

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def spans(
        self, trace_id: "str | None" = None, limit: "int | None" = None
    ) -> "list[dict]":
        """Newest-last snapshot, optionally filtered to one trace; ``limit``
        keeps the most recent N after filtering."""
        with self._lock:
            out = list(self._spans)
        if trace_id:
            out = [r for r in out if r["trace_id"] == trace_id]
        if limit is not None and limit < len(out):
            out = out[len(out) - limit:]
        return out


EXPORTER = SpanExporter()


# -- renderings ---------------------------------------------------------------


def chrome_trace(records: "list[dict]") -> dict:
    """Chrome trace-viewer JSON (chrome://tracing, Perfetto's legacy JSON
    importer): complete "X" events in microseconds, with process/thread
    metadata naming the component/thread tracks."""
    pids: "dict[str, int]" = {}
    tids: "dict[tuple[int, str], int]" = {}
    events: "list[dict]" = []
    for r in records:
        pid = pids.setdefault(r["component"], len(pids) + 1)
        tid = tids.setdefault((pid, r["thread"]), len(tids) + 1)
        events.append(
            {
                "ph": "X",
                "name": r["name"],
                "cat": "tpu_dra",
                "pid": pid,
                "tid": tid,
                "ts": r["start_unix_s"] * 1e6,
                "dur": r["duration_s"] * 1e6,
                "args": {
                    "trace_id": r["trace_id"],
                    "span_id": r["span_id"],
                    "parent_id": r["parent_id"],
                    "status": r["status"],
                    **r["attributes"],
                },
            }
        )
    for component, pid in pids.items():
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": component},
            }
        )
    for (pid, thread), tid in tids.items():
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "args": {"name": thread},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_tree(records: "list[dict]") -> str:
    """Plain-text parent/child tree, one trace per block, spans in start
    order.  Spans whose parent is outside the buffer print at root level."""
    by_trace: "dict[str, list[dict]]" = {}
    for r in records:
        by_trace.setdefault(r["trace_id"], []).append(r)
    out: "list[str]" = []
    for trace_id in sorted(by_trace):
        spans = sorted(by_trace[trace_id], key=lambda r: r["start_unix_s"])
        ids = {r["span_id"] for r in spans}
        children: "dict[str, list[dict]]" = {}
        roots: "list[dict]" = []
        for r in spans:
            if r["parent_id"] and r["parent_id"] in ids:
                children.setdefault(r["parent_id"], []).append(r)
            else:
                roots.append(r)
        out.append(f"trace {trace_id} ({len(spans)} span(s))")

        def emit(r: dict, depth: int) -> None:
            attrs = " ".join(
                f"{k}={v}" for k, v in sorted(r["attributes"].items())
            )
            line = (
                f"{'  ' * depth}- {r['name']} "
                f"[{r['component']}] {r['duration_s'] * 1e3:.2f}ms "
                f"{r['status']}"
            )
            if r["status_message"]:
                line += f" ({r['status_message']})"
            if attrs:
                line += f" {attrs}"
            out.append(line)
            for event in r["events"]:
                out.append(
                    f"{'  ' * (depth + 1)}@{event['offset_s'] * 1e3:.2f}ms "
                    f"{event['name']}"
                )
            for child in children.get(r["span_id"], []):
                emit(child, depth + 1)

        for root in roots:
            emit(root, 1)
    return "\n".join(out) + ("\n" if out else "")
