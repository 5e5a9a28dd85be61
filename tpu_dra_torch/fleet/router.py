"""Prefix-affinity request routing across serve-engine replicas.

Counterpart of `tpu_dra.fleet.router`, decision for decision: given a
prompt and a snapshot of each replica (`ReplicaView`: its prefix digest,
live queue depth, batch occupancy and rolling goodput), `PrefixRouter`
answers with one `Placement`:

1. **Affinity**: the replica whose digest claims the longest resident
   window-aligned prefix of the prompt wins (ties: the hotter entry, then
   the lower load).  ``reason="affinity"``.
2. **Load shedding**: when the affinity winner's load exceeds the
   coldest replica's by more than ``load_skew`` (rounds of work a slot),
   the request goes to the coldest replica instead (``reason="load"``):
   recomputing a prefix is cheaper than queueing behind a hot spot.
3. **No match**: the least-loaded replica (``reason="load"``).

Load is ``(queue_depth + occupancy) / slots`` plus a goodput penalty: a
replica missing its SLOs (rolling goodput < 1) looks ``goodput_weight *
(1 - goodput)`` rounds more loaded.  Routing by affinity partitions the
hot prefixes across the replicas' pools, so N small pools behave like
one N-times-larger cache.

A stale digest is the caller's to catch: `ServeFleet` checks an affinity
placement against the live engine (`ServeEngine.peek_prefix`) and
re-routes by load with ``reason="spill"``.  ``policy="random"`` (seeded
through ``random.Random(seed)``) and ``policy="round_robin"`` are the
control arms.  Plain Python: no torch.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from tpu_dra_torch.fleet.digest import ReplicaDigest

__all__ = ["Placement", "PrefixRouter", "ReplicaView"]

POLICIES = ("affinity", "random", "round_robin")

# Placement reason vocabulary (the ``reason`` label of
# ``tpu_dra_fleet_routed_total``): affinity = digest match won; load =
# no usable match, or the match shed to a colder replica; spill = the
# fleet's live verify found the digest stale (entry evicted since
# refresh) and fell back to load routing; random / round_robin = the
# benchmark control policies.
AFFINITY, LOAD, SPILL = "affinity", "load", "spill"


@dataclass
class ReplicaView:
    """One replica's routing-relevant state at placement time."""

    name: str
    digest: "ReplicaDigest | None" = None
    queue_depth: int = 0
    occupancy: int = 0
    slots: int = 1
    goodput: "float | None" = None  # rolling, None = no SLO signal
    # Disaggregation tier (docs/SERVING.md "Disaggregated serving"):
    # decode-tier replicas are handoff TARGETS, never admission targets
    # — the router skips them; "mono" and "prefill" replicas admit.
    tier: str = "mono"


@dataclass
class Placement:
    """The router's answer: where, why, and on what evidence."""

    replica: str
    reason: str
    matched: int = 0  # digest-claimed prefix tokens (affinity only)
    load: float = 0.0  # chosen replica's load at placement
    digest_age_s: float = 0.0  # chosen replica's digest age (0 if none)
    # Loads of every candidate at decision time (observability: the
    # ``/debug/fleet`` record shows what the router saw, not just what
    # it picked).
    loads: "dict[str, float]" = field(default_factory=dict)

    def span_attributes(self) -> dict:
        """The placement as span attributes — the payload of the
        ``fleet.route`` ROOT span the fleet opens per routed request
        (docs/OBSERVABILITY.md "Request latency attribution"): where the
        request landed, why (``outcome`` = the reason vocabulary above),
        how many prompt tokens the digest claimed resident, and the
        load/digest evidence the decision stood on.  One shape for every
        outcome, so trace queries never branch on reason."""
        return {
            "replica": self.replica,
            "outcome": self.reason,
            "matched": self.matched,
            "load": round(self.load, 4),
            "digest_age_s": round(self.digest_age_s, 4),
        }


class PrefixRouter:
    """Stateless-per-request placement policy over `ReplicaView`s.

    ``load_skew``: how much hotter (rounds per slot) the affinity winner
    may run than the coldest replica before the request sheds to the
    cold one.  0 disables stickiness entirely (any imbalance sheds);
    large values trust affinity absolutely.  ``goodput_weight``: rounds
    of phantom load added per unit of missed goodput.  ``seed`` makes
    the random policy reproducible."""

    def __init__(self, *, policy: str = "affinity", load_skew: float = 2.0,
                 goodput_weight: float = 1.0, seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        if load_skew < 0:
            raise ValueError(f"load_skew must be >= 0, got {load_skew}")
        self.policy = policy
        self.load_skew = load_skew
        self.goodput_weight = goodput_weight
        self._rng = random.Random(seed)
        self._rr = 0

    def load_of(self, view: ReplicaView) -> float:
        load = (view.queue_depth + view.occupancy) / max(1, view.slots)
        if view.goodput is not None:
            load += self.goodput_weight * (1.0 - view.goodput)
        return load

    def route(self, prompt: "list[int]",
              views: "list[ReplicaView]") -> Placement:
        """Place ``prompt`` on one of ``views``; raises ValueError on an
        empty fleet (zero replicas is a config error, not a queue)."""
        if not views:
            raise ValueError("cannot route: no replicas")
        views = [v for v in views if v.tier != "decode"]
        if not views:
            raise ValueError(
                "cannot route: every replica is a decode-tier handoff "
                "target (a disaggregated fleet needs prefill or mono "
                "replicas at the front door)"
            )
        loads = {v.name: round(self.load_of(v), 4) for v in views}
        if self.policy == "random":
            pick = self._rng.choice(views)
            return Placement(
                replica=pick.name, reason="random",
                load=loads[pick.name], loads=loads,
                digest_age_s=pick.digest.age_s() if pick.digest else 0.0,
            )
        if self.policy == "round_robin":
            pick = views[self._rr % len(views)]
            self._rr += 1
            return Placement(
                replica=pick.name, reason="round_robin",
                load=loads[pick.name], loads=loads,
                digest_age_s=pick.digest.age_s() if pick.digest else 0.0,
            )

        coldest = min(views, key=lambda v: (loads[v.name], v.name))
        best, best_key = None, (0, 0, 0.0)
        for v in views:
            if v.digest is None:
                continue
            matched, hits = v.digest.lookup(prompt)
            if matched <= 0:
                continue
            # Longest match wins; among equals the hotter entry, then
            # the colder replica (negated load — higher key wins).
            key = (matched, hits, -loads[v.name])
            if best is None or key > best_key:
                best, best_key = v, key
        if best is None:
            return Placement(
                replica=coldest.name, reason=LOAD,
                load=loads[coldest.name], loads=loads,
                digest_age_s=(
                    coldest.digest.age_s() if coldest.digest else 0.0
                ),
            )
        if loads[best.name] - loads[coldest.name] > self.load_skew:
            # Shed: the prefix is there but the queue in front of it
            # costs more than recomputing the prefill somewhere cold.
            return Placement(
                replica=coldest.name, reason=LOAD,
                load=loads[coldest.name], loads=loads,
                digest_age_s=(
                    coldest.digest.age_s() if coldest.digest else 0.0
                ),
            )
        return Placement(
            replica=best.name, reason=AFFINITY, matched=best_key[0],
            load=loads[best.name], loads=loads,
            digest_age_s=best.digest.age_s(),
        )
