"""Paged KV pool introspection: the ``/debug/kv`` document.

Counterpart of `tpu_dra.obs.kv`.  This module never imports the engine:
a paged `parallel.serve.ServeEngine` registers a snapshot provider here
at construction (a weakref-backed callable returning
`ServeEngine.kv_snapshot`, or None once the engine is collected;
``close()`` unregisters it), and `kv_doc` reduces the live providers to
one JSON document: per engine its block counts, the age, heat, sharing
and free-run distributions, and one record per allocated block with its
refcount, origin, birth and last-touch step, age and owner tags
(``req:<id>`` table cells, ``entry:<len>t`` prefix entries).
`render_text` is the ``format=text`` form, which the reference's ``tpudra
kv`` CLI prints the same way.
"""

from __future__ import annotations

import logging
import threading

logger = logging.getLogger(__name__)

# Bucket edges for the derived histograms: block residency age in
# seconds (decode churn lives left, parked shared prefixes right) and
# idleness in device steps since last touch (the heat signal a
# block-level LRU would evict by).
AGE_BUCKETS_S = (0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0)
IDLE_BUCKETS_STEPS = (0, 1, 4, 16, 64, 256, 1024)
RUN_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_LOCK = threading.Lock()
_PROVIDERS: "dict[str, object]" = {}


def register(name: str, provider) -> None:
    """Register a pool snapshot provider under an engine name.  The
    provider is a zero-arg callable returning the snapshot dict, or
    ``None`` once its owner is gone (it is then auto-unregistered at the
    next read).  Two live engines sharing a name overwrite each other —
    the per-engine gauge discipline, documented on ``ServeEngine``."""
    with _LOCK:
        _PROVIDERS[name] = provider


def unregister(name: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(name, None)


def providers() -> "list[str]":
    with _LOCK:
        return sorted(_PROVIDERS)


def snapshots(engine: "str | None" = None) -> "list[dict]":
    """Live snapshots from every registered provider (or one engine's),
    name-sorted.  A provider returning ``None`` (its owner was
    collected) is dropped from the registry; one that RAISES is only
    skipped for this read (logged) — a transient failure mid-teardown
    must not permanently silence a live engine, and introspection must
    never take the debug server down either way."""
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
            logger.debug("kv snapshot provider %s failed: %s", name, e)
            continue
        if snap is None:
            dead.append((name, provider))
            continue
        out.append(snap)
    if dead:
        with _LOCK:
            for name, provider in dead:
                # Identity-checked: a NEW engine may have re-registered
                # under the recycled name between our read and this pop
                # (name recycling is a supported pattern) — only the
                # provider we actually saw die may be retired.
                if _PROVIDERS.get(name) is provider:
                    del _PROVIDERS[name]
    return out


def _bucketize(values, bounds) -> "list[dict]":
    """Non-cumulative bucket counts: one row per edge plus the overflow
    row (``le`` = null) — a rendering-friendly histogram, not the
    Prometheus cumulative form."""
    counts = [0] * (len(bounds) + 1)
    for v in values:
        for i, edge in enumerate(bounds):
            if v <= edge:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    rows = [
        {"le": edge, "count": counts[i]} for i, edge in enumerate(bounds)
    ]
    rows.append({"le": None, "count": counts[-1]})
    return rows


def engine_doc(snap: dict, limit: int = 256) -> dict:
    """One engine's ``/debug/kv`` entry from its raw snapshot: occupancy,
    the derived age/heat/sharing/fragmentation distributions, and the
    per-block records (hottest-shared first, capped at ``limit``)."""
    blocks = list(snap.get("blocks", ()))
    total = snap.get("blocks_total", 0)
    usable = max(0, total - 1)  # scratch is not capacity
    free = snap.get("blocks_free", 0)
    allocated = snap.get("blocks_allocated", 0)
    aliased = snap.get("blocks_aliased", 0)
    runs = list(snap.get("free_runs", ()))
    sharing: "dict[int, int]" = {}
    for b in blocks:
        sharing[b["refcount"]] = sharing.get(b["refcount"], 0) + 1
    # Most-shared first, then hottest: the blocks an operator (or an
    # eviction policy) cares about first.
    blocks.sort(key=lambda b: (-b["refcount"], b["idle_steps"]))
    return {
        "engine": snap.get("engine", ""),
        "block_size": snap.get("block_size", 0),
        "device_steps": snap.get("device_steps", 0),
        "blocks_total": total,
        "blocks_free": free,
        "blocks_allocated": allocated,
        "blocks_aliased": aliased,
        "occupancy": round(allocated / usable, 3) if usable else 0.0,
        "free_fraction": round(free / usable, 3) if usable else 0.0,
        "alias_blocks_total": snap.get("alias_blocks_total", 0),
        "cow_blocks_total": snap.get("cow_blocks_total", 0),
        "alloc_blocks_total": snap.get("alloc_blocks_total", 0),
        "blocks_host": snap.get("blocks_host", 0),
        "host_capacity": snap.get("host_capacity", 0),
        "swap_out_blocks_total": snap.get("swap_out_blocks_total", 0),
        "swap_in_blocks_total": snap.get("swap_in_blocks_total", 0),
        "preemptions_total": snap.get("preemptions_total", 0),
        "age_histogram": _bucketize(
            (b["age_s"] for b in blocks), AGE_BUCKETS_S
        ),
        "heat_histogram": _bucketize(
            (b["idle_steps"] for b in blocks), IDLE_BUCKETS_STEPS
        ),
        "sharing": [
            {"refcount": r, "blocks": n}
            for r, n in sorted(sharing.items())
        ],
        "fragmentation": {
            "free_blocks": free,
            "runs": len(runs),
            "longest_run": max(runs) if runs else 0,
            "histogram": _bucketize(runs, RUN_BUCKETS),
        },
        "blocks": blocks[:limit],
        "blocks_omitted": max(0, len(blocks) - limit),
    }


def kv_doc(engine: "str | None" = None, limit: int = 256) -> dict:
    """The ``/debug/kv`` JSON document (filters mirror the query
    parameters; `render_text` consumes exactly this shape)."""
    engines = [engine_doc(s, limit) for s in snapshots(engine)]
    return {"engines": engines, "count": len(engines)}


def _hist_line(rows: "list[dict]", unit: str = "") -> str:
    parts = []
    for row in rows:
        if not row["count"]:
            continue
        le = "inf" if row["le"] is None else f"{row['le']:g}"
        parts.append(f"<={le}{unit}:{row['count']}")
    return " ".join(parts) if parts else "(empty)"


def render_text(doc: dict) -> str:
    """Plain-text form of the document (``/debug/kv?format=text`` and
    ``tpudra kv`` render this byte-identically)."""
    if not doc.get("engines"):
        return (
            "no paged KV pools registered in this process "
            "(rows-layout engines have no blocks to introspect)\n"
        )
    out: "list[str]" = []
    for e in doc["engines"]:
        out.append(
            f"engine {e['engine']}: {e['blocks_total']} block(s) of "
            f"{e['block_size']} position(s) (scratch excluded: "
            f"{e['blocks_total'] - 1}), {e['blocks_free']} free "
            f"({e['free_fraction']:.0%}), {e['blocks_allocated']} "
            f"allocated ({e['occupancy']:.0%}), {e['blocks_aliased']} "
            f"aliased, step {e['device_steps']}"
        )
        out.append(
            f"  admissions: {e['alloc_blocks_total']} allocated, "
            f"{e['alias_blocks_total']} aliased zero-copy, "
            f"{e['cow_blocks_total']} COW"
        )
        if e["host_capacity"]:
            out.append(
                f"  host tier: {e['blocks_host']}/{e['host_capacity']} "
                f"block(s) resident, {e['swap_out_blocks_total']} "
                f"swapped out / {e['swap_in_blocks_total']} in, "
                f"{e['preemptions_total']} preemption(s)"
            )
        else:
            out.append("  host tier: disabled (park-only admission)")
        frag = e["fragmentation"]
        out.append(
            f"  fragmentation: {frag['free_blocks']} free in "
            f"{frag['runs']} run(s), longest {frag['longest_run']} — "
            f"runs {_hist_line(frag['histogram'])}"
        )
        out.append(f"  age: {_hist_line(e['age_histogram'], 's')}")
        out.append(
            f"  heat (steps idle): {_hist_line(e['heat_histogram'])}"
        )
        out.append(
            "  sharing: "
            + (
                " ".join(
                    f"ref{s['refcount']}x{s['blocks']}"
                    for s in e["sharing"]
                )
                or "(no allocated blocks)"
            )
        )
        if e["blocks"]:
            out.append(
                f"  {'block':>6} {'ref':>4} {'origin':<9} {'birth':>6} "
                f"{'touch':>6} {'idle':>5} {'age_s':>8} owners"
            )
            for b in e["blocks"]:
                out.append(
                    f"  {b['block']:>6} {b['refcount']:>4} "
                    f"{b['origin'] or '-':<9} {b['birth_step']:>6} "
                    f"{b['last_touch_step']:>6} {b['idle_steps']:>5} "
                    f"{b['age_s']:>8.3f} {','.join(b['owners']) or '-'}"
                )
            if e["blocks_omitted"]:
                out.append(
                    f"  ({e['blocks_omitted']} more block(s) past the "
                    "limit)"
                )
    return "\n".join(out) + "\n"
