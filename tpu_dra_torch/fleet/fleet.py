"""ServeFleet: N continuous-batching engines behind one prefix-affinity
front door.

Counterpart of `tpu_dra.fleet.fleet`, over the port's `ServeEngine`s
(any objects with its fleet surface: ``name``, ``validate_request``,
``submit(seed=, stop_sequences=, trace_parent=, enqueued_at=,
priority=)``, ``prefix_digest``, ``prefix_epoch``, ``peek_prefix``,
``slo_counts``, ``queue_depth``, ``occupancy``, ``slots``, ``pending``,
``tick``, ``request`` and ``close``):

- **Placement** (`PrefixRouter`): a request lands on the replica whose
  prefix cache holds the longest prefix of its prompt (digest-matched,
  then checked against the live index), unless that replica runs
  ``load_skew`` rounds hotter than the coldest; then it sheds.  The
  replicas' pools partition the hot prefixes instead of each holding
  all of them.
- **Digests**: each replica's `ServeEngine.prefix_digest` is cached and
  rebuilt when the engine's residency epoch moves
  (``digest_refresh="auto"``), or only on `refresh_digests()`
  (``"manual"``).  A stale claim is caught by `ServeEngine.peek_prefix`
  at placement and re-routed by load, recorded as ``reason="spill"``.
- **Fleet queue**: a replica admits at most ``max_queue_per_replica``
  waiters; when every replica is at its cap a request parks fleet-side
  and is placed when capacity frees, highest ``priority`` first and FIFO
  within a class.  Engine timelines are backdated to fleet arrival
  (``submit(enqueued_at=)``), so queue wait and TTFT keep measuring what
  the user saw.
- **Autoscaling signal**: `scale_hint()` folds aggregate goodput and
  queue growth into grow / shrink / hold.
- **Telemetry** (the port's own registries): every placement lands in
  `fleet.stats.RECORDER` (``/debug/fleet``) and moves
  ``tpu_dra_fleet_routed_total{replica,reason}`` and
  ``tpu_dra_fleet_route_total{outcome}``; scrape-time gauges sample the
  fleet queue, the load skew and each replica's digest age through weak
  references.  Each routed request is one trace: `submit` mints its root
  context, placement emits the ``fleet.route`` root span (a spill is an
  event on it) and hands the context to ``ServeEngine.submit``, so the
  engine's ``serve.*`` spans sit under it.

Not copied: ``bind_claim``, which joins a claim to the fleet in the
capacity ledger's claim half, and that half belongs to the control
plane, which runs no compute (the port leaves it out).

Greedy outputs do not depend on the routing policy: every replica runs
the same weights and config, and each engine's prefix cache is exact, so
where a request runs moves its latency, not its tokens (up to bf16
near-ties between a cached and a recomputed prefix on the card).

The fleet is driven from one loop (submit and tick are not re-entrant);
`tick()` fans the replicas' steps out over a thread pool, and `run()`
lets each replica drain itself in its own thread once placement is done.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from tpu_dra_torch.fleet import stats
from tpu_dra_torch.fleet.router import (
    AFFINITY,
    LOAD,
    SPILL,
    Placement,
    PrefixRouter,
    ReplicaView,
)
from tpu_dra_torch.utils import servestats, trace
from tpu_dra_torch.utils.metrics import (
    FLEET_DIGEST_AGE,
    FLEET_LOAD_SKEW,
    FLEET_QUEUE_DEPTH,
    FLEET_ROUTE_TOTAL,
    FLEET_ROUTED,
    FLEET_SCALE_HINTS,
)

__all__ = ["ServeFleet"]

GROW, SHRINK, HOLD = "grow", "shrink", "hold"

DIGEST_REFRESH_MODES = ("auto", "manual")


# The perf_counter -> wall-clock anchor for retro span records (one
# shared conversion; see trace.unix_of).
_unix_of = trace.unix_of


def _digest_age(fleet, replica: str) -> float:
    """Scrape-time digest age: one .get() into a local — the serve
    thread pops/replaces ``_digests`` entries unlocked, so a
    check-then-index in the scrape thread would race into a KeyError."""
    digest = fleet._digests.get(replica)
    return 0.0 if digest is None else digest.age_s()


def _weak_sampler(ref: "weakref.ref", fn):
    """Scrape-time gauge callback holding only a weakref to the fleet
    (the serve.py discipline): None retires the series once the fleet is
    collected, close() retires it deterministically."""

    def sample():
        fleet = ref()
        return None if fleet is None else fn(fleet)

    return sample


@dataclass
class _Pending:
    """A fleet-queued request: validated at arrival, placed later."""

    fid: int
    prompt: "list[int]"
    max_new: "int | None"
    seed: "int | None"
    stop_sequences: "list[list[int]] | None"
    use_prefix_cache: bool
    enqueued_at: float
    priority: int = 0
    # The request's fleet-wide trace root, minted at submit: the
    # fleet.route span takes this identity at placement and the engine
    # parents its serve.* spans under it, so one trace id covers the
    # whole routed journey (docs/OBSERVABILITY.md "Request latency
    # attribution").
    trace_ctx: "trace.TraceContext | None" = field(
        default=None, repr=False
    )
    placement: "Placement | None" = field(default=None, repr=False)


_FLEET_IDS = itertools.count()


class ServeFleet:
    """N `ServeEngine` replicas behind one prefix-affinity router.

    ``engines``: a non-empty list of engines with DISTINCT names and the
    same model params/config (the token-identity contract assumes one
    model; mixed fleets are a config error).  ``policy`` / ``load_skew``
    / ``goodput_weight`` / ``seed`` build the default `PrefixRouter`
    (pass ``router=`` to override wholesale).
    ``max_queue_per_replica``: waiters one replica may hold before it is
    closed for placement (default: its ``slots`` — one full extra round
    of work); when all replicas are closed, requests park fleet-side.
    ``digest_refresh``: ``"auto"`` refreshes a replica's digest whenever
    its residency epoch moved; ``"manual"`` only on `refresh_digests()`.
    ``parallel_ticks``: fan `tick()` out over a thread pool (default on
    for multi-replica fleets).  ``goodput_floor`` / ``shrink_below``
    tune `scale_hint` (grow below the floor; shrink when idle below the
    occupancy fraction)."""

    def __init__(
        self,
        engines,
        *,
        router: "PrefixRouter | None" = None,
        policy: str = "affinity",
        load_skew: float = 2.0,
        goodput_weight: float = 1.0,
        seed: int = 0,
        max_queue_per_replica: "int | None" = None,
        digest_refresh: str = "auto",
        parallel_ticks: bool = True,
        goodput_floor: float = 0.9,
        shrink_below: float = 0.25,
        name: "str | None" = None,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError(
                "a fleet needs at least one ServeEngine replica"
            )
        names = [e.name for e in engines]
        if len(set(names)) != len(names):
            raise ValueError(
                f"replica names must be distinct, got {names} "
                "(pass name= to ServeEngine)"
            )
        if digest_refresh not in DIGEST_REFRESH_MODES:
            raise ValueError(
                f"digest_refresh must be one of {DIGEST_REFRESH_MODES}, "
                f"got {digest_refresh!r}"
            )
        if max_queue_per_replica is not None and max_queue_per_replica < 1:
            raise ValueError(
                "max_queue_per_replica must be >= 1 (0 would close every "
                f"replica forever), got {max_queue_per_replica}"
            )
        self._engines: "dict[str, object]" = {e.name: e for e in engines}
        self.router = router or PrefixRouter(
            policy=policy, load_skew=load_skew,
            goodput_weight=goodput_weight, seed=seed,
        )
        self.digest_refresh = digest_refresh
        self.goodput_floor = goodput_floor
        self.shrink_below = shrink_below
        self.name = name or f"fleet-{next(_FLEET_IDS)}"
        self._caps = {
            e.name: (
                max_queue_per_replica
                if max_queue_per_replica is not None
                else max(1, e.slots)
            )
            for e in engines
        }
        self._digests: "dict[str, object]" = {}
        self._goodput_cache: "dict[str, tuple[int, float | None]]" = {}
        self._queue: "collections.deque[_Pending]" = collections.deque()
        self._by_fid: "dict[int, tuple[str, int] | None]" = {}
        self._next_fid = 0
        self._placed: "dict[str, int]" = {n: 0 for n in names}
        self._routed: "dict[str, int]" = {}
        self._queue_samples: "collections.deque[tuple[int, int]]" = (
            collections.deque(maxlen=256)
        )
        self._ticks = 0
        self._closed = False
        # Worker count is bounded by the host's cores: an engine tick is
        # host dispatch plus the device's work, and more concurrent
        # dispatchers than cores only add contention.
        workers = min(len(engines), os.cpu_count() or 1)
        self._pool = (
            ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix=f"{self.name}-tick",
            )
            if parallel_ticks and len(engines) > 1 and workers > 1
            else None
        )
        # One lock over placement bookkeeping: samplers read loads and
        # queue depth from the scrape thread while the serve loop mutates
        # them (the engines' own lists are read without it — CPython list
        # reads are atomic enough for a gauge).
        self._lock = threading.Lock()

        ref = weakref.ref(self)
        FLEET_QUEUE_DEPTH.set_function(
            _weak_sampler(ref, lambda f: len(f._queue)), fleet=self.name
        )
        FLEET_LOAD_SKEW.set_function(
            _weak_sampler(ref, lambda f: f._load_skew_now()),
            fleet=self.name,
        )
        for n in names:
            FLEET_DIGEST_AGE.set_function(
                _weak_sampler(ref, lambda f, n=n: _digest_age(f, n)),
                fleet=self.name, replica=n,
            )

    # -- replica state ---------------------------------------------------
    @property
    def replicas(self) -> "list[str]":
        return list(self._engines)

    def engine(self, replica: str):
        return self._engines[replica]

    def _digest_of(self, engine) -> "object":
        cached = self._digests.get(engine.name)
        if self.digest_refresh == "auto":
            if cached is None or cached.epoch != engine.prefix_epoch:
                cached = engine.prefix_digest()
                self._digests[engine.name] = cached
        elif cached is None:
            cached = engine.prefix_digest()
            self._digests[engine.name] = cached
        return cached

    def refresh_digests(self) -> "dict[str, object]":
        """Rebuild every replica's digest from its live index NOW — the
        whole refresh story under ``digest_refresh="manual"``, a no-op
        worth of freshness under ``"auto"``."""
        for name, eng in self._engines.items():
            self._digests[name] = eng.prefix_digest()
        return dict(self._digests)

    def _rolling_goodput(self, replica: str, window: int = 64):
        """Rolling goodput from the replica's step flight recorder (the
        PR-5 telemetry): delta of cumulative met/missed over the last
        ``window`` recorded ticks; falls back to the engine's lifetime
        counts when the ring has too little, None when no SLO is
        configured (nothing to be good at)."""
        eng = self._engines[replica]
        if eng.ttft_slo_s is None and eng.tpot_slo_s is None:
            # No targets configured: there is nothing to be good at,
            # and scanning the recorder ring per placement would be
            # pure routing overhead.
            return None
        # The ring scan is O(capacity) under the recorder lock; fence a
        # per-replica cache on the recorder's monotonic sequence so N
        # submits between ticks (no new records) pay it once, not N
        # times per replica.
        seq = servestats.RECORDER.recorded
        cached = self._goodput_cache.get(replica)
        if cached is not None and cached[0] == seq:
            return cached[1]
        met, missed = eng.slo_counts
        records = servestats.RECORDER.query(engine=replica, limit=window)
        value = None
        if len(records) >= 2:
            dm = records[-1].slo_met - records[0].slo_met
            dx = records[-1].slo_missed - records[0].slo_missed
            if dm + dx > 0:
                value = dm / (dm + dx)
        if value is None and met + missed > 0:
            value = met / (met + missed)
        self._goodput_cache[replica] = (seq, value)
        return value

    def _views(self) -> "list[ReplicaView]":
        return [
            ReplicaView(
                name=name,
                digest=self._digest_of(eng),
                queue_depth=eng.queue_depth,
                occupancy=eng.occupancy,
                slots=eng.slots,
                goodput=self._rolling_goodput(name),
                tier=getattr(eng, "tier", "mono"),
            )
            for name, eng in self._engines.items()
        ]

    def _load_skew_now(self) -> float:
        """Max-min replica load (no digest refresh: scrape-safe)."""
        loads = [
            (e.queue_depth + e.occupancy) / max(1, e.slots)
            for e in self._engines.values()
        ]
        return round(max(loads) - min(loads), 4) if loads else 0.0

    # -- submission ------------------------------------------------------
    def submit(self, prompt: "list[int]", max_new: "int | None" = None,
               *, seed: "int | None" = None,
               stop_sequences: "list[list[int]] | None" = None,
               use_prefix_cache: bool = True,
               priority: int = 0) -> int:
        """Route a request into the fleet; returns a FLEET-wide id (use
        `result()` to fetch the finished Request).  Validation happens
        here, eagerly, against the replica contract (engines share one
        config) — even when the request parks in the fleet queue.  When
        every replica is at its admission cap the request waits
        fleet-side and is placed by a later `tick()`; its timeline is
        backdated so queue wait and TTFT still start NOW.  ``priority``
        flows through to the chosen replica's admission control
        (``ServeEngine.submit(priority=)``): the per-class isolation the
        engines enforce — priority admission and, on swap-tier engines,
        preemption — is addressable from the fleet front door, and the
        request's priority is its SLO class in ``/debug/requests``."""
        self._check_open()
        # Any replica's validator speaks for all (one shared config).
        next(iter(self._engines.values())).validate_request(
            prompt, max_new, seed, stop_sequences, priority
        )
        fid = self._next_fid
        self._next_fid += 1
        item = _Pending(
            fid=fid, prompt=list(prompt), max_new=max_new, seed=seed,
            stop_sequences=stop_sequences,
            use_prefix_cache=use_prefix_cache,
            enqueued_at=time.perf_counter(),
            priority=priority,
            trace_ctx=trace.TraceContext.new(),
        )
        self._by_fid[fid] = None
        # Queue discipline: while older requests wait fleet-side, a new
        # arrival joins the line — placing it immediately would let it
        # jump capacity that freed since the last tick.  The line is
        # priority-ordered at PLACEMENT (`_queue_head`), strict FIFO
        # within a class: a priority-blind fleet queue would park
        # high-priority arrivals behind a low-priority flood and defeat
        # the very preemption the engines run (the front door must honor
        # the same classes the admission control does).
        if self._queue or not self._try_place(item):
            with self._lock:
                self._queue.append(item)
        return fid

    def _place_queued(self) -> None:
        """Drain the fleet queue into freed capacity, highest priority
        first and earliest fleet arrival among equals —
        `ServeEngine._head_index` lifted to the fleet tier, so
        default-priority traffic stays strict FIFO and a high-priority
        arrival routes past a parked low-priority flood instead of
        behind it.  ONE sorted pass per tick (submit/tick are not
        re-entrant, so the snapshot is exact): a 10k-deep flood drains
        in O(N log N), not a head-rescan per placement.  Placement
        stops at the first unplaceable item in priority order — the
        head-of-line discipline, now per class ordering."""
        if not self._queue:
            return
        pending = sorted(
            self._queue, key=lambda r: (-r.priority, r.enqueued_at)
        )
        placed: "set[int]" = set()
        for item in pending:
            if not self._try_place(item):
                break
            placed.add(item.fid)
        if placed:
            with self._lock:
                remaining = [
                    i for i in self._queue if i.fid not in placed
                ]
                self._queue.clear()
                self._queue.extend(remaining)

    def _open_views(self) -> "list[ReplicaView]":
        return [
            v for v in self._views()
            if v.queue_depth < self._caps[v.name]
        ]

    def _try_place(self, item: _Pending) -> bool:
        """Route ``item`` onto an open replica; False when every replica
        is at cap (caller parks it fleet-side)."""
        views = self._open_views()
        if not views:
            return False
        if not item.use_prefix_cache and self.router.policy == "affinity":
            # The request is barred from reusing any prefix (privacy
            # opt-out): an affinity win would pile it onto the hottest
            # replica only to pay a full prefill there anyway — route it
            # by load alone.
            loads = {
                v.name: round(self.router.load_of(v), 4) for v in views
            }
            coldest = min(views, key=lambda v: (loads[v.name], v.name))
            placement = Placement(
                replica=coldest.name, reason=LOAD,
                load=loads[coldest.name], loads=loads,
            )
        else:
            placement = self.router.route(item.prompt, views)
        route_events: "list[dict]" = []
        if placement.reason == AFFINITY:
            eng = self._engines[placement.replica]
            if eng.peek_prefix(item.prompt) <= 0:
                # The digest promised a prefix the live index no longer
                # holds (evicted since refresh): drop the lie, fall back
                # to load routing, and count the spill — the router's
                # staleness story in one branch.
                stale_age = placement.digest_age_s
                affinity_replica = placement.replica
                self._digests.pop(placement.replica, None)
                coldest = min(
                    views,
                    key=lambda v: (placement.loads[v.name], v.name),
                )
                placement = Placement(
                    replica=coldest.name, reason=SPILL,
                    load=placement.loads[coldest.name],
                    loads=placement.loads, digest_age_s=stale_age,
                )
                # The re-route is an EVENT on the request's one routing
                # span, never a fresh trace: /debug/traces?trace_id=
                # shows the promised replica, the landing replica, and
                # everything the landing replica then did, in one tree.
                route_events.append(
                    {
                        "name": "spill",
                        "offset_s": round(
                            time.perf_counter() - item.enqueued_at, 9
                        ),
                        "attributes": {
                            "from_replica": affinity_replica,
                            "to_replica": coldest.name,
                            "digest_age_s": round(stale_age, 4),
                        },
                    }
                )
        eng = self._engines[placement.replica]
        rid = eng.submit(
            item.prompt, item.max_new, seed=item.seed,
            stop_sequences=item.stop_sequences,
            use_prefix_cache=item.use_prefix_cache,
            enqueued_at=item.enqueued_at,
            priority=item.priority,
            trace_parent=item.trace_ctx,
        )
        # The fleet-wide trace ROOT, retro-emitted now that the route is
        # decided: identity = the context minted at fleet submit (which
        # the engine's serve.request just parented under), duration =
        # fleet arrival -> engine handoff (routing work + any fleet
        # -side queue wait), attributes = the placement's evidence.
        now = time.perf_counter()
        trace.emit_span(
            "fleet.route", context=item.trace_ctx,
            start_unix_s=_unix_of(item.enqueued_at),
            duration_s=now - item.enqueued_at,
            events=route_events,
            fleet=self.name, request=item.fid,
            queue_depth=len(self._queue),
            **placement.span_attributes(),
        )
        with self._lock:
            self._by_fid[item.fid] = (placement.replica, rid)
            self._placed[placement.replica] += 1
            self._routed[placement.reason] = (
                self._routed.get(placement.reason, 0) + 1
            )
        FLEET_ROUTED.inc(replica=placement.replica, reason=placement.reason)
        FLEET_ROUTE_TOTAL.inc(outcome=placement.reason)
        stats.RECORDER.record(
            stats.PlacementRecord(
                fleet=self.name, request=item.fid,
                replica=placement.replica, reason=placement.reason,
                matched=placement.matched, load=placement.load,
                digest_age_s=round(placement.digest_age_s, 4),
                queue_depth=len(self._queue), loads=placement.loads,
                trace_id=item.trace_ctx.trace_id,
            )
        )
        return True

    # -- the fleet loop --------------------------------------------------
    def tick(self) -> "list":
        """Place fleet-queued requests into freed capacity, then run one
        tick on every replica with work (fanned over the thread pool:
        a replica's wait on its device, and torch's native work, release
        the GIL, so replica steps overlap there; Python dispatch does
        not).  Returns the requests that finished."""
        self._check_open()
        self._place_queued()
        busy = [e for e in self._engines.values() if e.pending]
        if self._pool is not None and len(busy) > 1:
            finished_lists = list(
                self._pool.map(lambda e: e.tick(), busy)
            )
        else:
            finished_lists = [e.tick() for e in busy]
        finished = [r for lst in finished_lists for r in lst]
        self._ticks += 1
        total_queue = len(self._queue) + sum(
            e.queue_depth for e in self._engines.values()
        )
        self._queue_samples.append((self._ticks, total_queue))
        return finished

    def run(self, until_idle: int = 10_000) -> "list":
        """Tick until the fleet queue and every replica drain; returns
        all requests completed during the call.

        While fleet-queued requests remain, the loop steps via `tick()`
        (placement needs a consistent cross-replica view, so replicas
        step in lockstep).  Once placement is DONE, replicas have no
        shared state left to coordinate — each one drains itself in its
        own thread, free-running (no per-tick barrier), which is the
        deployment shape: independent engines on independent hosts.
        The drains overlap where the GIL is released (device waits,
        torch's native work): the wall-clock half of the fleet's
        aggregate throughput (the other half is prefix-working-set
        partitioning).  Replicas on one card share its current stream,
        so their device work runs one after another."""
        done = []
        budget = until_idle
        while budget > 0:
            busy = [e for e in self._engines.values() if e.pending]
            if not self._queue and not busy:
                break
            if self._queue or self._pool is None or len(busy) < 2:
                done.extend(self.tick())
                budget -= 1
                continue
            budget -= self._drain_free_running(busy, budget, done)
        # Re-check AFTER the loop: a fleet that drained on exactly the
        # last budgeted tick is drained, not stuck.
        if self._queue or any(e.pending for e in self._engines.values()):
            raise RuntimeError("fleet did not drain within the tick bound")
        return done

    def _drain_free_running(self, busy, budget: int, done: "list") -> int:
        """Drain ``busy`` replicas concurrently, each ticking itself dry
        (bounded by ``budget`` ticks); extends ``done`` and returns the
        tick cost (the deepest replica's count — ticks ran in
        parallel)."""

        def drain_one(eng):
            finished, ticks = [], 0
            while eng.pending and ticks < budget:
                finished.extend(eng.tick())
                ticks += 1
            return finished, ticks

        results = list(self._pool.map(drain_one, busy))
        for finished, _ in results:
            done.extend(finished)
        self._ticks += max(t for _, t in results)
        self._queue_samples.append(
            (
                self._ticks,
                sum(e.queue_depth for e in self._engines.values()),
            )
        )
        return max(t for _, t in results)

    def result(self, fid: int):
        """The finished (or in-flight) Request for a fleet id; None while
        the request still waits in the fleet queue."""
        where = self._by_fid.get(fid)
        if where is None:
            return None
        replica, rid = where
        return self._engines[replica].request(rid)

    # -- autoscaling signal ----------------------------------------------
    def scale_hint(self, *, window: int = 16) -> dict:
        """grow / shrink / hold from aggregate goodput vs queue growth —
        the autoscaler's input, json-able for kubesim consumption:

        - **grow**: aggregate goodput fell below ``goodput_floor``, or
          the total queue exceeds fleet row capacity and grew over the
          last ``window`` ticks — more replicas, or SLOs bleed.
        - **shrink**: no queue anywhere, occupancy under
          ``shrink_below`` of capacity, goodput healthy — capacity is
          idle (never hinted below one replica).
        - **hold**: everything else.
        """
        self._check_open()
        engines = self._engines.values()
        queue_now = len(self._queue) + sum(e.queue_depth for e in engines)
        occupancy = sum(e.occupancy for e in engines)
        capacity = sum(e.slots for e in engines)
        samples = [
            q for _, q in list(self._queue_samples)[-max(2, window):]
        ]
        queue_growth = queue_now - samples[0] if samples else queue_now
        met = missed = 0
        for e in engines:
            m, x = e.slo_counts
            met, missed = met + m, missed + x
        goodput = met / (met + missed) if met + missed else None
        if (goodput is not None and goodput < self.goodput_floor) or (
            queue_now > capacity and queue_growth > 0
        ):
            hint, why = GROW, (
                f"goodput {goodput:.3f} < floor {self.goodput_floor}"
                if goodput is not None and goodput < self.goodput_floor
                else f"queue {queue_now} > capacity {capacity} and growing"
            )
        elif (
            queue_now == 0
            and occupancy <= self.shrink_below * capacity
            and len(self._engines) > 1
            and (goodput is None or goodput >= self.goodput_floor)
        ):
            hint, why = SHRINK, (
                f"idle: occupancy {occupancy}/{capacity} rows, no queue"
            )
        else:
            hint, why = HOLD, "within operating band"
        FLEET_SCALE_HINTS.inc(hint=hint)
        return {
            "hint": hint,
            "reason": why,
            "replicas": len(self._engines),
            "queue_depth": queue_now,
            "queue_growth": queue_growth,
            "occupancy": occupancy,
            "capacity": capacity,
            "goodput": round(goodput, 3) if goodput is not None else None,
        }

    # -- introspection / teardown ----------------------------------------
    def fleet_stats(self) -> dict:
        """Snapshot for tests and debugging: placements, reasons, queue,
        and per-replica live state + digest identity."""
        return {
            "name": self.name,
            "replicas": {
                name: {
                    "queue_depth": eng.queue_depth,
                    "occupancy": eng.occupancy,
                    "slots": eng.slots,
                    "placements": self._placed[name],
                    "cap": self._caps[name],
                    "digest": (
                        self._digests[name].to_dict()
                        if name in self._digests
                        else None
                    ),
                }
                for name, eng in self._engines.items()
            },
            "routed": dict(self._routed),
            "fleet_queue_depth": len(self._queue),
            "requests": self._next_fid,
            "load_skew": self._load_skew_now(),
        }

    def close(self) -> None:
        """Tear the fleet down: stop the tick pool, retire the fleet's
        gauge series, and close every replica (the fleet OWNS them).
        Idempotent; `fleet_stats` and `result` stay readable."""
        if self._closed:
            return
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        FLEET_QUEUE_DEPTH.remove_function(fleet=self.name)
        FLEET_LOAD_SKEW.remove_function(fleet=self.name)
        for name, eng in self._engines.items():
            FLEET_DIGEST_AGE.remove_function(fleet=self.name, replica=name)
            eng.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"ServeFleet {self.name!r} is closed: no further "
                "submissions or ticks"
            )
