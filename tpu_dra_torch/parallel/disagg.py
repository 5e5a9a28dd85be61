"""Disaggregated prefill/decode serving over the paged pool.

Counterpart of `tpu_dra.parallel.disagg`.  `DisaggServer` splits serving
into two tiers of `serve.ServeEngine`:

- the **prefill tier** admits waiting requests in waves budgeted by
  prompt windows, prefills each prompt into paged blocks and fetches its
  first token, and runs no decode step (``tier="prefill"``);
- the **decode tier** receives each prefilled request as a block table,
  never a row copy, and runs the decode steps to the finish.

The handoff unit is the block table:

- ``handoff="alias"``: both tiers share one allocator and one pool dict,
  and a handoff moves the row's block references into the decode
  engine's table, with no device copy.  The port's pool is written in
  place (the prefill, the decode step and `paged.copy_block` return the
  dict they were given), so the two engines share it once, at
  construction; nothing is rebound after a tier's tick.
- ``handoff="dma"``: each tier keeps its own pool, and each block goes
  through a bounded `swap.HostBlockPool` staging area: one
  `paged.read_block` fetch to pinned memory, one `paged.write_block`
  restore.  The bytes round-trip exactly, so greedy decoding continues
  token for token.

A long-prompt burst then prefills outside the engine that decodes for
everyone else.  When the decode tier is saturated (its queue at
``decode_queue_cap``, or the staging pool full) handoffs defer, prefill
rows stay occupied, admission waves stall and the server's backlog grows
(``disagg_stats()["backlog"]``, the ``tpu_dra_disagg_prefill_queue_depth``
gauge).

A handed-off request stays one trace: the ``fleet.route`` root (minted
at `submit`, emitted at the prefill placement), ``serve.queue`` and
``serve.admit`` on the prefill tier, ``prefill.run``, ``handoff.alias``
or ``handoff.dma``, then ``serve.decode`` and ``serve.request`` on the
decode tier.

Tiers on a mesh (``mesh=`` in both specs: every rank builds its own
server over its shards of the params and drives it with the same calls)
must share one mesh.  Under alias both tiers of a rank share one pool
dict (the rank's heads of every block) and one allocator; under dma
every rank stages its own heads of each block through its own
`HostBlockPool`.  The host scheduling is the same on every rank, so are
the handoffs; no collective is added.
"""

from __future__ import annotations

import itertools
import time
import weakref

import torch

from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.parallel.swap import HostBlockPool
from tpu_dra_torch.utils import trace
from tpu_dra_torch.utils.metrics import DISAGG_PREFILL_QUEUE_DEPTH

__all__ = ["DisaggServer", "HANDOFF_MODES"]

_SERVER_IDS = itertools.count()

HANDOFF_MODES = ("alias", "dma")

# Engine knobs the server owns: tier identity, engine names, the paged
# layout the handoff needs, and the telemetry switch.
_RESERVED_SPEC_KEYS = ("tier", "name", "kv_layout", "telemetry")


def _same_mesh(a, b) -> bool:
    """Whether two tier specs' meshes (None: one device) are one mesh:
    the same ranks in the same layout under the same axis names."""
    if a is None or b is None:
        return a is b
    return a is b or (a.mesh_dim_names == b.mesh_dim_names and torch.equal(a.mesh, b.mesh))


class _Pending:
    """A request held by the server: validated at arrival, placed on the
    prefill tier by a later admission wave.  ``windows`` is its prompt's
    block-grid footprint, the unit the wave budget spends."""

    __slots__ = (
        "did", "prompt", "max_new", "seed", "stop_sequences",
        "use_prefix_cache", "priority", "enqueued_at", "trace_ctx", "windows",
    )

    def __init__(self, did, prompt, max_new, seed, stop_sequences,
                 use_prefix_cache, priority, enqueued_at, trace_ctx, windows):
        self.did = did
        self.prompt = prompt
        self.max_new = max_new
        self.seed = seed
        self.stop_sequences = stop_sequences
        self.use_prefix_cache = use_prefix_cache
        self.priority = priority
        self.enqueued_at = enqueued_at
        self.trace_ctx = trace_ctx
        self.windows = windows


class DisaggServer:
    """Two tier-sized `ServeEngine`s behind one admission front door.

    ``prefill`` / ``decode``: ServeEngine keyword arguments for each tier
    (``slots``, ``kv_blocks``, ``attn_backend``, SLO targets, ``device``
    ...); the server sets ``tier``, ``name``, the paged layout and
    ``telemetry`` itself, so those keys are rejected.  Both
    tiers serve one model (``params``, ``config``: one weight tree, whose
    bf16 matrices both engines share), one block size
    (``prefix_window``) and one pool format (``kv_int8``): the handoff
    payload is a block table in that format.

    ``handoff="alias"``: the tiers share one pool, sized by the decode
    spec's ``kv_blocks`` (a prefill-spec ``kv_blocks`` is rejected); the
    prefill engine's own pool is dropped at construction.
    ``handoff="dma"``: each tier keeps its pool, and blocks go through a
    ``staging_blocks``-slot `HostBlockPool` (default: one worst-case
    row).

    ``prefill_wave``: the admission wave's budget a tick, in prompt
    windows (block-grid columns), not requests: one long prompt spends
    what many short ones would share (default: two worst-case prompts).
    ``decode_queue_cap``: handoffs defer while the decode engine holds
    this many waiters (default: its ``slots``).  ``telemetry``: both
    tiers' (`serve.ServeEngine`) and the server's ``fleet.route`` spans.

    ``mesh`` in a spec puts that tier on a mesh of ranks (module
    docstring): both specs must name the same mesh (a handoff moves a
    rank's heads of each block, which only the same mesh lays out
    alike), else the server is refused."""

    def __init__(
        self,
        params,
        config,
        *,
        prefill: dict,
        decode: dict,
        handoff: str = "alias",
        staging_blocks: "int | None" = None,
        prefill_wave: "int | None" = None,
        decode_queue_cap: "int | None" = None,
        telemetry: bool = True,
        name: "str | None" = None,
    ):
        if handoff not in HANDOFF_MODES:
            raise ValueError(f"handoff must be one of {HANDOFF_MODES}, got {handoff!r}")
        for label, spec in (("prefill", prefill), ("decode", decode)):
            bad = sorted(set(spec) & set(_RESERVED_SPEC_KEYS))
            if bad:
                raise ValueError(
                    f"the {label} spec must not set {bad}: the DisaggServer wires tier "
                    "identity, engine names, the paged layout and telemetry itself"
                )
        if handoff == "alias" and prefill.get("kv_blocks") is not None:
            raise ValueError(
                "handoff='alias' shares ONE device pool between the tiers, sized by the "
                "decode spec's kv_blocks — a prefill-spec kv_blocks would size a pool that "
                "is immediately discarded"
            )
        if handoff == "alias" and staging_blocks is not None:
            raise ValueError(
                "staging_blocks only applies to handoff='dma' (the alias handoff moves "
                "references, nothing is staged)"
            )
        if not _same_mesh(prefill.get("mesh"), decode.get("mesh")):
            raise ValueError(
                "the tiers must run on one mesh (both specs' mesh the same ranks, layout and "
                "axis names, or neither set): a handoff moves each rank's heads of a block, "
                "which only the same mesh lays out alike"
            )
        self.name = name or f"disagg-{next(_SERVER_IDS)}"
        self.handoff = handoff
        self.telemetry = telemetry
        self._prefill = ServeEngine(params, config, tier="prefill", telemetry=telemetry,
                                    name=f"{self.name}-prefill", **prefill)
        self._decode = ServeEngine(params, config, tier="decode", telemetry=telemetry,
                                   name=f"{self.name}-decode", **decode)
        if self._prefill.block_size != self._decode.block_size:
            raise ValueError(
                "the tiers must share one block size: the handoff unit is a block table "
                f"(prefill prefix_window {self._prefill.block_size} vs decode "
                f"{self._decode.block_size})"
            )
        if self._prefill.kv_int8 != self._decode.kv_int8:
            raise ValueError(
                "the tiers must share one pool format (kv_int8): the handoff payload is a "
                "block table in that format — apply kv_int8 to both specs or neither"
            )
        self._w = self._prefill.block_size
        self._shared_pool = handoff == "alias"
        if self._shared_pool:
            shared_total = self._decode._balloc.num_blocks
            floor = self._prefill._table_cols + 1 + (1 if self._prefill._prefix is not None else 0)
            if shared_total < floor:
                raise ValueError(
                    f"the shared pool (decode kv_blocks={shared_total}) must hold at least "
                    f"{floor} blocks — one worst-case prefill-tier admission (its table "
                    "columns, a COW block when the prefix cache could park it) + scratch"
                )
            # One allocator and one pool dict for both tiers.  This drops
            # the last reference to the prefill engine's own pool, which
            # is freed here, before the first tick.  A prefill-tier prefix
            # cache refs its blocks in the shared allocator too.
            self._prefill._balloc = self._decode._balloc
            self._prefill._pool = self._decode._pool
            if self._prefill._prefix is not None:
                self._prefill._prefix._alloc = self._decode._balloc
            self._staging = None
        else:
            cap = self._prefill._table_cols if staging_blocks is None else staging_blocks
            if cap < self._prefill._table_cols:
                raise ValueError(
                    f"staging_blocks must be >= {self._prefill._table_cols} (one worst-case "
                    "row — a smaller staging pool could never stream the longest legal "
                    f"request), got {cap}"
                )
            self._staging = HostBlockPool(cap)
        windows = self._prefill.prompt_slots // self._w
        wave = 2 * windows if prefill_wave is None else prefill_wave
        if wave < windows:
            raise ValueError(
                f"prefill_wave must be >= {windows} windows (one worst-case prompt — a "
                "smaller wave budget could never admit the longest legal request), "
                f"got {wave}"
            )
        self.prefill_wave = wave
        self.decode_queue_cap = (
            self._decode.slots if decode_queue_cap is None else decode_queue_cap
        )
        if self.decode_queue_cap < 1:
            raise ValueError(
                "decode_queue_cap must be >= 1 (0 would defer every handoff forever), "
                f"got {decode_queue_cap}"
            )
        self._backlog: "list[_Pending]" = []
        self._by_did: "dict[int, object]" = {}
        self._next_did = 0
        self._done: "list" = []
        self._deferred_handoffs = 0
        self._closed = False
        # Everything waiting for prefill-tier capacity: the backlog and
        # the prefill engine's queue (the series retires with the server).
        ref = weakref.ref(self)

        def backlog():
            srv = ref()
            return None if srv is None else len(srv._backlog) + len(srv._prefill._queue)

        DISAGG_PREFILL_QUEUE_DEPTH.set_function(backlog, server=self.name)

    # -- tier access -------------------------------------------------------
    @property
    def tiers(self) -> "dict[str, ServeEngine]":
        """The tier engines by role."""
        return {"prefill": self._prefill, "decode": self._decode}

    @property
    def staging(self) -> "HostBlockPool | None":
        """The dma staging pool (None under ``handoff="alias"``)."""
        return self._staging

    # -- admission front door ----------------------------------------------
    def submit(self, prompt: "list[int]", max_new: "int | None" = None, *,
               seed: "int | None" = None,
               stop_sequences: "list[list[int]] | None" = None,
               use_prefix_cache: bool = True, priority: int = 0) -> int:
        """Queue a request for the prefill tier; returns a server-wide id
        (`result` fetches its Request).  Checks, all here: the prefill
        engine's `validate_request`, and the handoff contract: the
        request's whole block table must fit a decode-tier row and, under
        dma, the staging pool, or its handoff could never complete."""
        self._check_open()
        budget, stops = self._prefill.validate_request(
            prompt, max_new, seed, stop_sequences, priority
        )
        cols = -(-(len(prompt) + budget) // self._w)
        if cols > self._decode._table_cols:
            raise ValueError(
                f"request needs {cols} blocks but a decode-tier row holds "
                f"{self._decode._table_cols} — size the decode tier (prompt_slots + "
                "max_new_cap) for the prefill tier's longest admitted request"
            )
        if self._staging is not None and cols > self._staging.capacity:
            raise ValueError(
                f"request needs {cols} blocks but the dma staging pool holds "
                f"{self._staging.capacity} — its handoff could never stream (raise "
                "staging_blocks)"
            )
        did = self._next_did
        self._next_did += 1
        self._backlog.append(_Pending(
            did=did, prompt=list(prompt), max_new=budget, seed=seed, stop_sequences=stops,
            use_prefix_cache=bool(use_prefix_cache), priority=priority,
            enqueued_at=time.perf_counter(), trace_ctx=trace.TraceContext.new(),
            windows=-(-len(prompt) // self._w),
        ))
        return did

    def _admit_wave(self) -> int:
        """Place backlogged requests on the prefill tier, highest priority
        first and earliest arrival among equals, spending at most
        ``prefill_wave`` prompt windows.  The wave stops at the first
        request that would overrun what is left of the budget, or when
        the prefill engine's queue would outgrow its free rows.  Returns
        the requests placed."""
        if not self._backlog:
            return 0
        room = sum(r is None for r in self._prefill._row_req) - len(self._prefill._queue)
        if room <= 0:
            return 0
        budget = self.prefill_wave
        placed: "set[int]" = set()
        for item in sorted(self._backlog, key=lambda p: (-p.priority, p.enqueued_at)):
            if len(placed) >= room or item.windows > budget:
                break
            budget -= item.windows
            rid = self._prefill.submit(
                item.prompt, item.max_new, item.seed, item.stop_sequences,
                use_prefix_cache=item.use_prefix_cache, enqueued_at=item.enqueued_at,
                priority=item.priority, trace_parent=item.trace_ctx,
            )
            self._by_did[item.did] = self._prefill.request(rid)
            placed.add(item.did)
            if self.telemetry:
                # The request's trace root: arrival to the prefill placement.
                trace.emit_span(
                    "fleet.route", context=item.trace_ctx,
                    start_unix_s=trace.unix_of(item.enqueued_at),
                    duration_s=time.perf_counter() - item.enqueued_at, fleet=self.name,
                    request=item.did, replica=self._prefill.name, reason="prefill",
                    tier="prefill", queue_depth=len(self._backlog),
                )
        if placed:
            self._backlog = [p for p in self._backlog if p.did not in placed]
        return len(placed)

    def _drain_prefill(self) -> int:
        """Hand prefilled rows to the decode tier, highest priority first.
        Every occupied prefill row is ready: the prefill tier runs no
        decode step, so its rows hold a finished prefill, the first token
        emitted and position and token frozen.  A handoff defers (the row
        stays, retried next tick) while the decode queue is at
        ``decode_queue_cap`` or the staging pool cannot hold the row.
        Returns the rows moved."""
        ready = [(row, req) for row, req in enumerate(self._prefill._row_req) if req is not None]
        ready.sort(key=lambda e: (-e[1].priority, e[1].enqueued_at))
        moved = 0
        for row, _ in ready:
            if len(self._decode._queue) >= self.decode_queue_cap:
                self._deferred_handoffs += len(ready) - moved
                break
            payload = self._prefill.handoff_out(row, mode=self.handoff, staging=self._staging)
            if payload is None:  # the staging pool is full
                self._deferred_handoffs += len(ready) - moved
                break
            self._decode.handoff_in(payload)
            moved += 1
        return moved

    def tick(self) -> "list":
        """One server step: an admission wave into the prefill tier, the
        prefill tick (prefills and first tokens, no decode step), the
        handoff of every prefilled row it can, the decode tick.  Returns
        the requests that finished in it (decode-tier finishes, and
        one-token requests that finished in their admission wave)."""
        self._check_open()
        self._admit_wave()
        done = list(self._prefill.tick())
        self._drain_prefill()
        done.extend(self._decode.tick())
        if self._shared_pool and not (
            self._prefill._pool is self._decode._pool
            and self._prefill._balloc is self._decode._balloc
        ):
            raise RuntimeError("alias handoff: the tiers no longer share one pool and allocator")
        self._done.extend(done)
        return done

    def run(self, until_idle: int = 10_000) -> "list":
        """Tick until the backlog and both tiers drain; returns the
        requests completed during the call.  ``until_idle`` bounds the
        loop."""
        done = []
        for _ in range(until_idle):
            if not self.pending:
                break
            done.extend(self.tick())
        else:
            raise RuntimeError("disagg server did not drain within the tick bound")
        return done

    @property
    def pending(self) -> bool:
        """True while the backlog or either tier holds work."""
        return bool(self._backlog or self._prefill.pending or self._decode.pending)

    def result(self, did: int):
        """The Request of a server id (in flight or finished); None while
        it waits in the backlog.  The object is tracked, not an engine
        id: the decode tier gives the request a new id at `handoff_in`."""
        return self._by_did.get(did)

    def disagg_stats(self) -> dict:
        """JSON-able accounting: the backlog, each tier's queue and
        occupancy, handoff traffic by direction and mode, the deferred
        handoffs, and the dma staging pool's slots."""
        pre, dec = self._prefill._handoff_counts, self._decode._handoff_counts
        stats = {
            "server": self.name,
            "handoff": self.handoff,
            "backlog": len(self._backlog),
            "deferred_handoffs": self._deferred_handoffs,
            "prefill": {
                "queue_depth": self._prefill.queue_depth,
                "occupancy": self._prefill.occupancy,
                "handoff_out_requests": pre["out_requests"],
                "handoff_out_blocks": pre["out_blocks"],
            },
            "decode": {
                "queue_depth": self._decode.queue_depth,
                "occupancy": self._decode.occupancy,
                "handoff_in_requests": dec["in_requests"],
                "handoff_in_blocks": dec["in_blocks"],
                "handoffs_alias": dec["alias"],
                "handoffs_dma": dec["dma"],
            },
        }
        if self._staging is not None:
            stats["staging"] = self._staging.stats()
        return stats

    def close(self) -> None:
        """Retire the backlog gauge and close both tier engines; later
        `submit` and `tick` raise.  Idempotent; finished requests stay
        readable."""
        self._closed = True
        DISAGG_PREFILL_QUEUE_DEPTH.remove_function(server=self.name)
        self._prefill.close()
        self._decode.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"DisaggServer {self.name!r} is closed: no further submissions or ticks "
                "(restart with a fresh server)"
            )
