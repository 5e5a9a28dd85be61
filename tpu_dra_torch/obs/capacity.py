"""The engines' half of the capacity ledger: the ``/debug/capacity``
document.

Counterpart of the engine side of `tpu_dra.obs.capacity`.  A
`parallel.serve.ServeEngine` registers a weakref-backed snapshot provider
here at construction (`ServeEngine.capacity_snapshot`: cumulative
occupancy-weighted busy and idle device seconds, whose sum is the
engine's summed tick wall time, the step count and the age of the last
step that held work; None once the engine is collected; ``close()``
unregisters it), and `snapshots` reads the live ones.

The ledger's claim half (``claim_allocated``, ``bind``, ``settle``, the
per-node fragmentation evidence, the chip-seconds counters) is fed by the
cluster controller's allocations, which a serving host of the port does
not run.  `capacity_doc` is therefore the reference's document with no
claim recorded: its ``engines`` rows carry the data, its claim, node and
class rollups are empty.
"""

from __future__ import annotations

import logging
import threading

logger = logging.getLogger(__name__)

# The reference's claim classes and stranded window: the document's
# ``class=`` filter and ``stranded_after`` answer as the reference's do.
CLASSES = ("tpu", "subslice", "core")
DEFAULT_STRANDED_AFTER_S = 5.0

_LOCK = threading.Lock()
_PROVIDERS: "dict[str, object]" = {}


def register(name: str, provider) -> None:
    """Register an engine's capacity snapshot provider: a zero-arg
    callable returning ``{"engine", "slots", "busy_s", "idle_s",
    "steps", "last_step_age_s"}``, or ``None`` once its owner is gone
    (unregistered at the next read).  Two live engines sharing a name
    overwrite each other."""
    with _LOCK:
        _PROVIDERS[name] = provider


def unregister(name: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(name, None)


def providers() -> "list[str]":
    with _LOCK:
        return sorted(_PROVIDERS)


def snapshots() -> "dict[str, dict]":
    """Live snapshots by engine name.  A provider returning ``None``
    retires itself (unless a new engine re-registered the name
    meanwhile); one that raises is only skipped for this read."""
    with _LOCK:
        items = sorted(_PROVIDERS.items())
    out: "dict[str, dict]" = {}
    dead: "list[tuple[str, object]]" = []
    for name, provider in items:
        try:
            snap = provider()
        except Exception:
            logger.debug("capacity provider %s raised; skipping this read", name,
                         exc_info=True)
            continue
        if snap is None:
            dead.append((name, provider))
            continue
        out[name] = snap
    if dead:
        with _LOCK:
            for name, provider in dead:
                if _PROVIDERS.get(name) is provider:
                    del _PROVIDERS[name]
    return out


def capacity_doc(limit: int = 256,
                 stranded_after_s: float = DEFAULT_STRANDED_AFTER_S) -> dict:
    """The ``/debug/capacity`` JSON document: the engines' rows (busy and
    idle seconds, utilization, steps, the last step's age) under the
    reference's keys, with no claim recorded."""
    snaps = snapshots()
    engines = []
    for name in sorted(snaps):
        snap = snaps[name]
        busy = float(snap.get("busy_s", 0.0))
        idle = float(snap.get("idle_s", 0.0))
        age = snap.get("last_step_age_s")
        engines.append({
            "engine": name,
            "slots": snap.get("slots", 0),
            "busy_s": round(busy, 6),
            "idle_s": round(idle, 6),
            "steps": snap.get("steps", 0),
            "utilization": round(busy / (busy + idle), 4) if busy + idle > 0 else None,
            "last_step_age_s": None if age is None else round(float(age), 3),
        })
    return {
        "claims": [],
        "claims_omitted": 0,
        "nodes": [],
        "classes": [],
        "engines": engines,
        "totals": {"chips_open": 0, "chips_stranded": 0, "busy_chip_s": 0.0,
                   "idle_chip_s": 0.0, "stranded_chip_s": 0.0, "closure": 1.0},
        "stranded_after_s": stranded_after_s,
        "count": 0,
        "recorded": 0,
        "dropped": 0,
    }


def render_text(doc: dict) -> str:
    """Plain-text form of the document (``format=text``), as the
    reference renders a ledger with no claim."""
    out = ["capacity ledger: 0 chip(s) open across 0 claim(s), closure 100%",
           "  (no allocations recorded in this process)"]
    engines = doc.get("engines", [])
    if engines:
        out.append("engines:")
        out.append(f"  {'engine':<20} {'slots':>5} {'busy_s':>9} {'idle_s':>9} "
                   f"{'util':>5} {'steps':>7} last_step")
        for e in engines:
            util = "-" if e["utilization"] is None else f"{e['utilization']:.2f}"
            age = ("never" if e["last_step_age_s"] is None
                   else f"{e['last_step_age_s']:.1f}s ago")
            out.append(f"  {e['engine']:<20} {e['slots']:>5} {e['busy_s']:>9.2f} "
                       f"{e['idle_s']:>9.2f} {util:>5} {e['steps']:>7} {age}")
    return "\n".join(out) + "\n"
