"""Continuous-batching serving engine.

Counterpart of `tpu_dra.parallel.serve.ServeEngine`, on one device or on
a mesh of ranks: two KV layouts, greedy or sampled decoding with
per-token logprobs, continuous scheduling or fused ticks.

- ``kv_layout="paged"`` (the default for dense models): a pool of KV
  blocks addressed through per-request block tables, with the memory
  hierarchy below and the CUDA paged-attention kernel.
- ``kv_layout="rows"`` (the default, and the only layout, for MoE
  models): one full-context cache row per slot.  A request is prefilled
  at B=1, padded to ``prompt_slots`` in ONE pass (a windowed prefill
  would restart the per-expert capacity queues, and so route other
  tokens than the one-shot prefill the model was trained with), and the
  whole row is copied into its slot; the decode step attends the rows
  through the dense masked attention (`decode._step_rows`).  Its
  prefix cache (dense models only) keeps prompts in a pool of rows
  (`prefixcache.PrefixCache`): a hit copies the prefix into the new
  request's B=1 cache and prefills only the windows after it.  No block
  table, so neither the kernel, the swap tier nor handoff.

Every batch ROW has its own lifecycle (paged; the rows layout admits by
prefill and whole-row insert) —

    submit -> queue -> admit into a free row (alias the resident prefix
    blocks, allocate the rest, prefill the suffix windows into them) ->
    per-row decode steps -> finish (eos / budget) -> row and blocks
    freed -> next request admitted

— while the device runs one fixed-batch decode step for all rows.  Rows
without a request keep stepping with a frozen position (there is no
ragged batch): their table rows point at scratch block 0, so their
writes land there and nowhere else.

The KV memory hierarchy:

- **Shared-prefix cache** (``prefix_cache_slots > 0``): a radix index
  over admitted prompts (`prefixcache.PagedPrefixCache`) whose entries
  hold refcounted block lists into THE pool.  A hit aliases the
  window-aligned prefix blocks into the new table (zero device copies)
  and prefills only the windows after them; parking a prompt is free
  (the entry refs the blocks admission just wrote); the partial last
  prompt block, shared by the entry and its live request, is privatized
  by an eager copy-on-write (`paged.copy_block`) before the first decode
  step writes into it.  A block with more than one owner is never
  written.
- **Admission**: the head is the highest-priority waiting request
  (strict FIFO within a priority).  It admits when its worst-case block
  demand (minus the alias credit) fits the free list, escalating through
  the block-granular LRU trim of unpinned entries and then — with a host
  tier — the PREEMPTION of a strictly-lower-priority mid-decode row:
  its blocks are copied to pinned host memory (`swap.HostBlockPool`),
  its row and blocks freed, and it swaps back in bitwise once blocks
  free.  When all three rungs fail the head parks in the queue.
- **Handoff**: `handoff_out` ships a row's block table to another
  engine's `handoff_in`, as references (``"alias"``, engines sharing one
  allocator and pool dict) or as block copies through a staging
  `HostBlockPool` (``"dma"``); the receiving engine restores the row at
  its next admission with position and pending token frozen.

Sampling (``temperature > 0``, optionally ``top_k``/``top_p``) is keyed
by the request: the token that lands in position p of a request draws
from ``fold_in(key(seed), p)`` (`prng`, JAX's Threefry bit for bit), so
a request's output depends on its seed and positions only, never on the
slot, the tick or the engine that served it, and survives preemption,
swap-in and handoff unchanged.  The sampler runs on the device, inside
the step, for every row at once.  ``with_logprobs`` keeps the raw
model's logprob of every generated token in ``Request.logprobs``.

Scheduling: ``"continuous"`` runs each of a tick's ``steps_per_tick``
steps as its own device call, with join/leave between them;
``"tick"`` runs them back to back in ONE device call, tokens and
positions fed forward on the device, the active mask fixed at the call's
start.  A row whose request finishes mid-call steps on to the call's end;
those steps are counted (`wasted_steps`) and their tokens dropped, and
a row that walks past its table's reach or the context reads and writes
scratch block 0 only.

There is exactly ONE blocking device-to-host fetch per device call (one
decode step under ``"continuous"``, ``steps_per_tick`` of them under
``"tick"``: tokens, logprobs and positions come back together) and one
per admission wave (all of a wave's first tokens and their logprobs
come back together).  Prefix hits add none; a preemption and a dma
handoff add one each (their block copies to host).  The host state the
device needs (tokens, positions, the active mask, the seeds, the block
tables, the padded prompts, a wave's seeds and lengths) goes up through
pinned staging buffers, without a host sync.

The engine surface a fleet and a `disagg.DisaggServer` call: ``name``
and ``tier``, `validate_request` returning the budget and the stop
sequences, seeds, stop sequences, SLO verdicts and `slo_counts`, and warm
restart (`export_prefix_index`, `warm_start`, `prefix_digest`).

On a mesh (``mesh=``, a `DeviceMesh`; one process a rank, each running
its own engine on its shards of the params, `weights.shard_params`)
every rank runs the same host scheduler on the same submissions.  The
decode step's rows lie as `decode` lays a batch out (over data x fsdp
where ``slots`` divides their product, else replicated), heads over
``model``; tokens and positions come back global on every rank (one
all-gather over ``data`` a step, with the logprobs).  An admission's
B=1 prefill is replicated over data x fsdp: every rank runs it (its
collectives are symmetric) and its first token is the same everywhere;
on rows only the row's owner inserts it; on paged every rank writes
its heads of the blocks, and a decode step's new K/V are all-gathered
before the scatter, so the pool's replicas stay equal.  KV is read by
the gather (the CUDA kernel serves one device, as the reference's).  A
host decision that read a wall clock would split the ranks and hang a
collective: the allocator's block ages, which the swap victim policy
ranks by, are counted in device steps on a mesh.  The host-sync
contract is unchanged.

Telemetry, the reference's whole surface over the port's own registries
(`tpu_dra_torch.utils.metrics`, `trace`, `servestats` and
`tpu_dra_torch.obs`): every request carries one trace id whose spans
(``serve.queue`` / ``serve.admit`` / ``serve.decode`` under a
``serve.request`` root; ``serve.swapout`` / ``serve.swapin``,
``prefill.run`` and ``handoff.<mode>`` where they happen) land in the
process's span ring; every ``tick()`` appends a `servestats.StepRecord`
whose phases (admit, dispatch, fetch, host) are stamped with
``perf_counter`` around work the tick does anyway (the dispatch ends
where the call's one blocking fetch starts: no sync is added); the
counters and histograms move where the reference's do; scrape-time
gauges and the ``/debug/kv``, ``/debug/requests`` and
``/debug/capacity`` providers hold the engine by weak reference and
``close()`` retires them.  ``telemetry=False`` drops the spans, the step
records and the per-token observations, as the reference's does.  The
``serve.admit`` span splits the time to first token after the queue:
``prefill_s``, the request's own admission (prefix match, blocks, its
prefill call's issue), and ``wave_wait_s``, the rest until its first
token is noted: the wave's later admissions, its sample and its one
fetch (``queue_wait_s + prefill_s + wave_wait_s`` is the time from
enqueue to first token).

Under a profiler (`profile_steps`, which captures the next device calls
under `torch.profiler`, or any other) the engine marks its phases as
ranges on the profiler's clock, beside the kernels they launch
(`trace.range`; nothing is recorded and nothing allocated while no
profiler runs): ``engine.tick`` over a tick; ``engine.admit``,
``engine.dispatch``, ``engine.fetch`` and ``engine.host`` where the
step record's phases are stamped; ``engine.prefill`` over each
admission's prefill call; inside the model, ``decode.attn`` over each
block's attention half and ``moe.route``, ``moe.dispatch``,
``moe.experts``, ``moe.combine`` over the expert layer's parts.  An
idle gap of the card inside ``engine.admit`` is time the card waited
on admission.  On a mesh every rank records its own.
"""

from __future__ import annotations

import itertools
import os
import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_dra_torch.fleet.digest import ReplicaDigest, build_digest, empty_digest
from tpu_dra_torch.obs import capacity as obscap
from tpu_dra_torch.obs import kv as obskv
from tpu_dra_torch.obs import requests as obsreq
from tpu_dra_torch.parallel import prng, spmd
from tpu_dra_torch.parallel.burnin import BurninConfig
from tpu_dra_torch.parallel.decode import (
    _build_prefill_padded,
    _build_prefill_suffix,
    _check_window,
    _chosen_logprob,
    _make_pick,
    _Rows,
    _step_rows,
    _validate_filters,
    copy_prefix_into_row,
    init_cache,
)
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.paged import (
    MESH_KERNEL_REFUSAL,
    BlockAllocator,
    PartGraphs,
    _tree_map,
    copy_block,
    read_block,
    write_block,
)
from tpu_dra_torch.parallel.prefixcache import PagedPrefixCache, PrefixCache
from tpu_dra_torch.parallel.quant import is_quantized
from tpu_dra_torch.parallel.swap import AgeHeatPolicy, HostBlockPool
from tpu_dra_torch.utils import servestats, trace
from tpu_dra_torch.utils.metrics import (
    DISAGG_HANDOFF_BLOCKS,
    DISAGG_HANDOFFS,
    SERVE_BATCH_OCCUPANCY,
    SERVE_DECODE_STEPS,
    SERVE_KV_ALIAS,
    SERVE_KV_BLOCKS,
    SERVE_KV_COW,
    SERVE_KV_FREE_RUN_BLOCKS,
    SERVE_KV_SWAPS,
    SERVE_MOE_ASSIGNMENTS,
    SERVE_PREFILL_TOKENS,
    SERVE_PREFILL_WINDOWS,
    SERVE_QUEUE_DEPTH,
    SERVE_QUEUE_WAIT_SECONDS,
    SERVE_SLO_TOTAL,
    SERVE_STEP_PHASE_SECONDS,
    SERVE_TIER_ENGINES,
    SERVE_TPOT_SECONDS,
    SERVE_TTFT_SECONDS,
    SERVE_WASTED_STEPS,
)

__all__ = ["Request", "ServeEngine"]

# Default engine names.
_ENGINE_IDS = itertools.count()

# perf_counter stamps onto the wall clock, for span records.
_unix_of = trace.unix_of

# Profiler ranges (`trace.range`): one a step phase, named from the
# step record's phases so the two cannot drift apart, opened and closed
# where that phase's perf_counter stamps are taken; the whole tick; and
# each admission's prefill call, inside the admit phase.
_PHASE_RANGE = {p: f"engine.{p}" for p in servestats.PHASES}
_TICK_RANGE = "engine.tick"
_PREFILL_RANGE = "engine.prefill"

# The paged engine's block-state gauge series.
_KV_STATES = ("free", "allocated", "aliased", "host")


def _weak_sampler(ref: "weakref.ref", fn):
    """A scrape-time gauge callback holding the engine by weak reference:
    None (the engine was collected) retires the series."""

    def sample():
        eng = ref()
        return None if eng is None else fn(eng)

    return sample


def _weak_provider(ref: "weakref.ref", method: str):
    """An obs provider holding the engine by weak reference: the named
    snapshot method's document, or None once the engine was collected."""

    def provide():
        eng = ref()
        return None if eng is None else getattr(eng, method)()

    return provide


@dataclass
class Request:
    """One submitted generation request and its accumulated output."""

    id: int
    prompt: "list[int]"
    max_new: int
    # The sampling key (default: the request id): the token at position
    # p draws from fold_in(key(seed), p).  Greedy output ignores it.
    seed: int = 0
    # Admission priority: higher admits first, equal priorities strictly
    # FIFO; a waiting request may preempt a strictly-lower-priority row.
    priority: int = 0
    # Token runs that end the request when generated (the matched suffix
    # stays in ``tokens``).
    stop_sequences: "list[list[int]]" = field(default_factory=list)
    tokens: "list[int]" = field(default_factory=list)  # generated only
    # The raw model's logprob of each generated token (engines built
    # with_logprobs=True; empty otherwise).
    logprobs: "list[float]" = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""  # "eos" | "stop" | "budget"
    # Prefix cache: the submit-time opt-out, and the prompt tokens whose
    # prefill admission skipped by aliasing resident blocks.
    use_prefix_cache: bool = True
    prefix_reused: int = 0
    # Blocks this request's table held while mid-decode (aliased ones too).
    kv_blocks: int = 0
    # Preemption: how often this request was swapped out, by which
    # request ids, whether it is parked on host now, the blocks copied
    # each way, the seconds from swap-out start to swap-in completion,
    # and the block-copy share of them (both directions).
    preemptions: int = 0
    preempted_by: "list[int]" = field(default_factory=list)
    swapped: bool = False
    swap_out_blocks: int = 0
    swap_in_blocks: int = 0
    swapped_s: float = 0.0
    swap_dma_s: float = 0.0
    # Handoff: moves between engines, the blocks moved, the mode of the
    # last move ("alias" | "dma"), and the seconds parked between them.
    handoffs: int = 0
    handoff_blocks: int = 0
    handoff_mode: str = ""
    handoff_s: float = 0.0
    submitted_at: float = 0.0  # host perf_counter
    ttft_s: float = 0.0  # submit -> first token, queueing included
    # The engine that serves the request (`ServeEngine.name`, stamped at
    # submit and at handoff_in): ids are unique per engine only, so
    # (replica, id) is the fleet-wide key.
    replica: str = ""
    # Timeline on the host perf_counter clock: enqueued (== submitted_at)
    # <= admitted <= first token <= finished; queue_wait_s = admitted -
    # enqueued; tpot_s is the mean of token_deltas, the arrival gap before
    # each token after the first (0.0 until a second token lands).
    enqueued_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    queue_wait_s: float = 0.0
    tpot_s: float = 0.0
    token_deltas: "list[float]" = field(default_factory=list)
    # SLO verdicts stamped at finish on an engine with targets:
    # {"ttft" | "tpot" | "request": "met" | "missed"}; "request" is met
    # when every evaluated target was (the goodput bit).
    slo: "dict[str, str]" = field(default_factory=dict)
    # Trace identity: every span of the request carries trace_id.  A
    # request submitted with a parent context (a router's span) joins
    # that trace, and its serve.request span parents under it.
    trace_id: str = ""
    trace_ctx: "trace.TraceContext | None" = field(default=None, repr=False)
    trace_parent: "trace.TraceContext | None" = field(default=None, repr=False)
    # A top-k expert model's chosen experts at each position the request
    # fed, (positions, expert layers, k) uint8 on the device (engines
    # built with record_routes; None otherwise).
    routes: object = field(default=None, repr=False)
    _last_token_at: float = field(default=0.0, repr=False)
    _swapped_at: float = field(default=0.0, repr=False)
    _handoff_at: float = field(default=0.0, repr=False)


class ServeEngine:
    """Fixed-slot continuous-batching engine on a paged block pool or on
    full-context cache rows.

    ``slots``: concurrent rows (the decode batch).  ``prompt_slots``:
    admission pad width; longer prompts are rejected at submit.
    ``max_new_cap``: the largest budget a request may ask for.
    ``eos_token``: generation stops early when the model emits it (None:
    budget only).  ``steps_per_tick``: decode steps each `tick` runs:
    each its own device call with join/leave between them under
    ``scheduling="continuous"`` (default), all in one device call under
    ``scheduling="tick"`` (rows that finish mid-call burn the rest:
    `wasted_steps`).

    ``temperature``: 0 (default) decodes greedily; above 0 samples the
    temperature-scaled logits, restricted by ``top_k``/``top_p`` when
    given, each request under its own seed (`submit`).
    ``with_logprobs``: record each generated token's raw-model logprob
    in ``Request.logprobs``.

    ``kv_layout``: ``"paged"`` or ``"rows"``; None (default) picks
    ``"rows"`` for an MoE model (which ``"paged"`` refuses) and
    ``"paged"`` otherwise.  The block knobs below (``kv_blocks``,
    ``host_kv_blocks``, ``swap_policy``) and the prefill/decode tiers
    need ``"paged"``.

    ``attn_backend``: how a decode step reads KV — ``"cuda"`` runs the
    paged-attention CUDA kernel, ``"gather"`` gathers the table's reach
    for the dense attention (on rows: the dense attention over the
    rows), ``"auto"`` (default) picks ``"cuda"`` on a paged CUDA engine
    of one device and ``"gather"`` otherwise.  ``"cuda"`` on a CPU
    engine, on rows or on a mesh raises.  ``prefill_chunk``: the rows
    layout's admission prefill runs in windows of that many tokens (it
    must divide ``prompt_slots``; refused with experts, as
    `decode.make_generate`'s); on paged the prefill runs on the block
    grid, so it must equal the block size.  ``prefix_window``: the block
    size W, and the prefix cache's window on rows; it must divide
    ``prompt_slots`` (default: ``prefill_chunk`` when given, else the
    largest divisor of ``prompt_slots`` up to a quarter of it).
    ``kv_int8``: the pool stores int8 values with one f32 scale per
    token and head (each written row quantized once, at insert).

    ``prefix_cache_slots``: resident entries of the shared-prefix cache
    (0, the default, turns it off; on rows, the rows of its pool; MoE
    models refuse it).  ``kv_blocks``: blocks in the pool,
    scratch included (default: every slot can hold a worst-case request,
    plus, with the cache on, room for the entries' prompt blocks and one
    COW block a slot — ``slots * ceil((prompt_slots + max_new_cap) / W)
    + 1 + prefix_cache_slots * prompt_slots / W + slots``); it must hold
    one worst-case request, its COW block with the cache on, and scratch.
    ``host_kv_blocks``: slots of the host swap tier (default twice the
    usable pool, allocated as used; 0 turns preemption off).
    ``swap_policy``: the victim picker (`swap.VictimPolicy`; default
    `swap.AgeHeatPolicy`).

    ``ttft_slo_s`` / ``tpot_slo_s``: optional latency targets; every
    finished request gets met/missed verdicts (``Request.slo``, the
    ``tpu_dra_serve_slo_total{slo,verdict}`` counters) and the request
    verdict adds to `slo_counts`.  ``telemetry`` (default on): the
    request spans, the step flight recorder and the per-token TPOT
    observations; off, the engine serves bare (the per-request summary
    metrics, the SLO counters and the capacity split stay on, as the
    reference's).  ``name``: the engine's identity as a fleet replica and
    the label of its gauge series, flight-recorder rows and obs providers
    (default ``engine-<n>``; two live engines must not share one).
    ``tier``:
    ``"mono"`` (default), or one tier of a `disagg.DisaggServer`: a
    ``"prefill"`` engine admits, prefills and fetches first tokens but
    runs no decode step (its rows wait, frozen, for `handoff_out`); a
    ``"decode"`` engine serves like a mono one.

    ``device``: where the pool and the computation live (default
    ``"cuda"``; raises when CUDA is absent).  ``params`` must be on it,
    plain or int8 (`quant.quantize_params`); the engine serves from a
    copy whose plain layer matrices are bf16, int8 pairs as they are
    (bf16 matrices are shared with ``params``, not copied).  A paged
    engine on one CUDA device captures its admission prefill's windows
    and its decode step as CUDA graphs here, from the parts its model
    hands over (`paged.PartGraphs`), and replays them (a decode tier,
    which never prefills, captures no windows, and a prefill tier, which
    never decodes, no step); on the CPU and on a mesh both are launched
    op by op.

    ``config``: a `BurninConfig`, or a `models.mla_moe.MlaMoeConfig`
    (DeepSeek-V3's block: latent attention and top-k experts), which
    serves on the paged layout through its own pool, prefill windows and
    decode step (the config's `paged_model`, the engine's one seam to its
    model) and refuses what that model does not serve yet (int8, the
    prefix cache, swap, the disaggregated tiers, the rows layout, meshes).
    ``record_routes``: keep each request's chosen experts at every
    position it fed (``Request.routes``, on the device; a top-k expert
    model only).

    ``mesh``: serve on a `DeviceMesh` of ranks (module docstring): every
    rank builds its engine with its shards of the params
    (`weights.shard_params` of the whole tree, quantized first for int8)
    and drives it with the same calls; the engine lives on the rank's
    device (``device`` is not read)."""

    def __init__(
        self,
        params,
        config: BurninConfig,
        *,
        slots: int,
        prompt_slots: int,
        max_new_cap: int,
        eos_token: "int | None" = None,
        steps_per_tick: int = 1,
        scheduling: str = "continuous",
        attn_backend: str = "auto",
        temperature: float = 0.0,
        top_k: "int | None" = None,
        top_p: "float | None" = None,
        with_logprobs: bool = False,
        prefill_chunk: "int | None" = None,
        kv_layout: "str | None" = None,
        kv_blocks: "int | None" = None,
        host_kv_blocks: "int | None" = None,
        swap_policy=None,
        prefix_cache_slots: int = 0,
        prefix_window: "int | None" = None,
        kv_int8: bool = False,
        ttft_slo_s: "float | None" = None,
        tpot_slo_s: "float | None" = None,
        telemetry: bool = True,
        name: "str | None" = None,
        tier: str = "mono",
        mesh=None,
        device: "str | torch.device" = "cuda",
        record_routes: bool = False,
    ):
        c = config
        # The model's side of the paged engine (the config's
        # `paged_model`): the served tree, the pool, the prefill windows
        # and the decode step, and what the model refuses.
        model = c.paged_model(slots=slots, positions=prompt_slots + max_new_cap,
                              record_routes=record_routes)
        model.refuse(kv_layout=kv_layout, kv_int8=kv_int8, quantized=is_quantized(params),
                     prefix_cache_slots=prefix_cache_slots, host_kv_blocks=host_kv_blocks,
                     tier=tier, mesh=mesh)
        if not model.swap_tier and host_kv_blocks is None:
            host_kv_blocks = 0
        if tier not in ("mono", "prefill", "decode"):
            raise ValueError(f"tier must be 'mono', 'prefill', or 'decode', got {tier!r}")
        place = None if mesh is None else spmd.Place(mesh)
        dev = resolve_device(device) if place is None else place.device
        # Every row must fit prompt + its budget in the context.
        _check_window(c, prompt_slots, max_new_cap, "prompt_slots")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if steps_per_tick < 1:
            raise ValueError(f"steps_per_tick must be >= 1, got {steps_per_tick}")
        if scheduling not in ("continuous", "tick"):
            raise ValueError(
                f"scheduling must be 'continuous' or 'tick', got {scheduling!r}"
            )
        _validate_filters(c.vocab, temperature > 0, top_k, top_p)
        model.check_chunk(prompt_slots, prefill_chunk)
        if prefix_cache_slots < 0:
            raise ValueError(f"prefix_cache_slots must be >= 0, got {prefix_cache_slots}")
        for knob, value in (("ttft_slo_s", ttft_slo_s), ("tpot_slo_s", tpot_slo_s)):
            if value is not None and not value > 0:
                raise ValueError(f"{knob} must be > 0, got {value}")
        if kv_layout is None:
            kv_layout = model.default_layout
        if kv_layout not in ("paged", "rows"):
            raise ValueError(f"kv_layout must be 'paged' or 'rows', got {kv_layout!r}")
        if tier != "mono" and kv_layout != "paged":
            raise ValueError(
                "prefill/decode tier engines require kv_layout='paged': "
                "the handoff unit is a block table (docs/SERVING.md "
                "\"Disaggregated serving\")"
            )
        if kv_blocks is not None and kv_layout != "paged":
            raise ValueError("kv_blocks only applies to kv_layout='paged'")
        if host_kv_blocks is not None:
            if kv_layout != "paged":
                raise ValueError(
                    "host_kv_blocks only applies to kv_layout='paged' "
                    "(the rows layout has no blocks to swap)"
                )
            if host_kv_blocks < 0:
                raise ValueError(f"host_kv_blocks must be >= 0, got {host_kv_blocks}")
        if swap_policy is not None and kv_layout != "paged":
            raise ValueError("swap_policy only applies to kv_layout='paged'")
        if attn_backend not in ("auto", "gather", "cuda"):
            raise ValueError(
                f"attn_backend must be 'auto', 'gather' or 'cuda', got {attn_backend!r}"
            )
        if attn_backend == "cuda" and kv_layout != "paged":
            raise ValueError(
                "attn_backend='cuda' is the paged-attention kernel: it "
                "requires kv_layout='paged' (the rows layout has no block "
                "tables to stream)"
            )
        if attn_backend == "cuda" and mesh is not None:
            raise ValueError(MESH_KERNEL_REFUSAL)
        if attn_backend == "auto":
            attn_backend = ("cuda" if kv_layout == "paged" and mesh is None and dev.type == "cuda"
                            else "gather")
        if attn_backend == "cuda" and dev.type != "cuda":
            raise ValueError(
                "attn_backend='cuda' runs the CUDA kernel: it needs a CUDA "
                f"engine, this one is on {dev}"
            )
        embed = params["embed"]["q"] if is_quantized(params) else params["embed"]
        if embed.device.type != dev.type:
            raise ValueError(f"params are on {embed.device}, the engine on {dev}")
        w = None
        if kv_layout == "paged" or prefix_cache_slots > 0:
            if prefix_window is not None:
                w = prefix_window
            elif prefill_chunk is not None:
                w = prefill_chunk
            else:
                # ~ a quarter prompt, rounded down to a divisor: the
                # reference's default block size.
                cap = max(1, prompt_slots // 4)
                w = max(d for d in range(1, cap + 1) if prompt_slots % d == 0)
            model.check_window(prompt_slots, w)
        if kv_layout == "paged" and prefill_chunk is not None and prefill_chunk != w:
            raise ValueError(
                f"paged prefill runs on the block grid: prefill_chunk ({prefill_chunk}) must "
                f"equal the block size ({w}) or be left unset"
            )

        self.config = c
        self.mesh = mesh
        # Where the decode step's rows lie on the mesh (None: one device).
        self._rows = None if place is None else _Rows(place, slots)
        self.prefill_chunk = prefill_chunk
        self.device = dev
        self._model = model
        self.params = model.prepare(params)
        self.slots = slots
        self.prompt_slots = prompt_slots
        self.max_new_cap = max_new_cap
        self.eos_token = eos_token
        self.steps_per_tick = steps_per_tick
        self.scheduling = scheduling
        # Steps fused into one device call: all of a tick's under "tick",
        # one under "continuous" (join/leave runs between calls).
        self._steps_per_call = 1 if scheduling == "continuous" else steps_per_tick
        # Steps spent on rows whose request finished earlier in the same
        # fused call (their tokens dropped): 0 under "continuous".
        self._wasted_steps = 0
        self.temperature = temperature
        self.with_logprobs = with_logprobs
        self.attn_backend = attn_backend
        self._kv_layout = kv_layout
        # The block size on paged; the prefix window on rows (None
        # without a prefix cache).
        self.block_size = w
        self.kv_int8 = kv_int8
        self.tier = tier
        self.name = name or f"engine-{next(_ENGINE_IDS)}"
        self.telemetry = telemetry
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self._slo_met = 0
        self._slo_missed = 0
        self._tokens_emitted = 0
        # The tick's phase accumulator: one dict zeroed by `tick`, which
        # `_admit` and `_step_once` add perf_counter spans to.
        self._phase_acc = dict.fromkeys(servestats.PHASES, 0.0)
        # `profile_steps`: device calls left to capture, the running
        # profiler, where its trace goes, its last failure.
        self._profile_left = 0
        self._profiler = None
        self._profile_dir = ""
        self._profile_error = ""
        self._kv_frag_ticks = 0  # the free-run observation's sampling count
        # The capacity split: occupancy-weighted busy and idle seconds,
        # whose sum is the ticks' summed wall time.
        self._cap_busy_s = 0.0
        self._cap_idle_s = 0.0
        self._cap_steps = 0
        self._cap_last_step_mono: "float | None" = None
        self._sampled = temperature > 0
        self._pick = _make_pick(self._sampled, temperature, top_k, top_p)
        self._prefill_tokens = {"computed": 0, "reused": 0}
        # Paged prefill windows run, by path (`_prefill_into`), decode
        # steps run, by path (`_step_once`), and the captured windows and
        # step that the graph paths replay (`_capture`; None where they
        # run op by op).
        self._prefill_windows = {"graph": 0, "eager": 0}
        self._decode_steps = {"graph": 0, "eager": 0}
        self._prefill_graphs: "PartGraphs | None" = None
        self._step_graphs: "PartGraphs | None" = None
        # The expert tally as `moe_assignments` last read it.
        self._moe_seen: "list[list[int]] | None" = None
        # Swapped-out and handed-in requests (paged only; empty on rows).
        self._swap_state: "dict[int, dict]" = {}
        self._handoff_state: "dict[int, dict]" = {}
        if kv_layout == "paged":
            self._init_paged(prefix_cache_slots, kv_blocks, host_kv_blocks, swap_policy)
        else:
            # One full-context row a slot; the B=1 admission prefill is
            # one pass over the padded prompt.
            self._table_cols = 0
            self._cache = init_cache(c, slots, kv_int8, device=dev, mesh=mesh)
            self._prefill1 = _build_prefill_padded(c, prompt_slots, prefill_chunk, mesh)
            self._prefix = None
            if prefix_cache_slots:
                self._prefix = PrefixCache(c, prefix_cache_slots, kv_int8=kv_int8, device=dev,
                                           mesh=mesh)
                self._suffix = _build_prefill_suffix(c, prompt_slots, w, mesh)
        # Host row state: the request, its position (== valid tokens in
        # the row), the token it feeds next, and the prefix entries it
        # pins (the one it read, the one it wrote); on paged, its block
        # table too.
        self._row_req: "list[Request | None]" = [None] * slots
        self._pos = [0] * slots
        self._tok = [0] * slots
        self._row_pins: "list[list]" = [[] for _ in range(slots)]
        # Pinned host staging (plain memory on a CPU engine), uploaded
        # without a host sync: one buffer for the per-call state — tok,
        # pos, active, seeds, then the tables — one for a wave's seeds and
        # lengths, and one admission row per slot (padded prompt, table
        # row, length).  Each is rewritten only after the fetch that ended
        # the device work reading it.  The per-call state uploads into one
        # device buffer, ``_state``, whose views are the captured decode
        # step's static inputs.
        pin = dev.type == "cuda"
        self._stage = torch.zeros(
            4 * slots + slots * self._table_cols, dtype=torch.int32, pin_memory=pin
        )
        self._state = torch.zeros(self._stage.shape, dtype=torch.int32, device=dev)
        self._wave_stage = torch.zeros(2 * slots, dtype=torch.int32, pin_memory=pin)
        self._prompt_stage = torch.zeros(
            (slots, prompt_slots + self._table_cols + 1), dtype=torch.int32,
            pin_memory=pin,
        )
        self._queue: "list[Request]" = []
        self._done: "list[Request]" = []
        self._by_id: "dict[int, Request]" = {}
        self._next_id = 0
        self._closed = False
        self._device_steps = 0
        if kv_layout == "paged":
            self._capture()
        self._register_telemetry()

    def _register_telemetry(self) -> None:
        """The engine's scrape-time gauges and its obs providers, each
        holding it by weak reference (a collected engine's series and
        providers retire themselves; `close` retires them at once)."""
        ref = weakref.ref(self)
        name = self.name
        if self._kv_layout == "paged":
            self._balloc.name = name
            obskv.register(name, _weak_provider(ref, "kv_snapshot"))
        obsreq.register(name, _weak_provider(ref, "request_class_stats"))
        obscap.register(name, _weak_provider(ref, "capacity_snapshot"))
        SERVE_QUEUE_DEPTH.set_function(_weak_sampler(ref, lambda e: len(e._queue)), engine=name)
        SERVE_BATCH_OCCUPANCY.set_function(
            _weak_sampler(ref, lambda e: sum(r is not None for r in e._row_req)), engine=name)
        SERVE_TIER_ENGINES.set_function(_weak_sampler(ref, lambda e: 1), engine=name,
                                        tier=self.tier)
        if self._kv_layout == "paged":
            for state, sample in zip(_KV_STATES, (
                lambda e: e._balloc.free_count,
                lambda e: e._balloc.allocated_count,
                lambda e: e._balloc.aliased_count,
                lambda e: e._host_pool.used_count,
            )):
                SERVE_KV_BLOCKS.set_function(_weak_sampler(ref, sample), engine=name, state=state)

    def _init_paged(self, prefix_cache_slots: int, kv_blocks: "int | None",
                    host_kv_blocks: "int | None", swap_policy) -> None:
        """The paged layout's state: the block pool and its allocator, the
        block tables, the prefix cache over the pool, the host swap tier
        and the handoff state."""
        c, w, slots = self.config, self.block_size, self.slots
        # Table width: enough columns for the longest legal request.
        # Shorter requests leave trailing columns at 0 (scratch).
        self._table_cols = -(-(self.prompt_slots + self.max_new_cap) // w)
        # With the cache on, room for the entries' prompt blocks and one
        # COW block a slot (a COW block only exists with a cache).
        cache_extra = (prefix_cache_slots * (self.prompt_slots // w) + slots
                       if prefix_cache_slots else 0)
        nb = kv_blocks if kv_blocks is not None else slots * self._table_cols + 1 + cache_extra
        # One worst-case request (its columns, its COW block when a cache
        # could park it) + scratch: below this some legal submit could
        # never admit.
        floor = self._table_cols + 1 + (1 if prefix_cache_slots else 0)
        if nb < floor:
            raise ValueError(
                f"kv_blocks must be >= {floor} (one worst-case request + scratch), got {nb}"
            )
        # On a mesh the blocks' ages are counted in device steps, which
        # every rank counts alike (wall clocks differ between ranks).
        self._balloc = (BlockAllocator(nb) if self.mesh is None else
                        BlockAllocator(nb, clock=lambda: float(self._device_steps)))
        self._pool = self._model.init_pool(nb, w, kv_int8=self.kv_int8, device=self.device,
                                           mesh=self.mesh)
        self._prefill = self._model.make_prefill(self.prompt_slots, w, mesh=self.mesh)
        self._prefix = (
            PagedPrefixCache(prefix_cache_slots, self._balloc, block_size=w)
            if prefix_cache_slots else None
        )
        self._kv_counts = {"alias_blocks": 0, "cow_blocks": 0, "alloc_blocks": 0}
        # The host swap tier, and the state of swapped-out requests:
        # req.id -> host slots in table-column order, the frozen position
        # and the pending next token.
        self._host_pool = HostBlockPool(2 * (nb - 1) if host_kv_blocks is None else host_kv_blocks)
        self._swap_policy = swap_policy or AgeHeatPolicy()
        self._swap_counts = {"out_blocks": 0, "in_blocks": 0, "preemptions": 0,
                             "in_requests": 0}
        # Handed-in requests parked until their restoring admission live
        # in _handoff_state: req.id -> mode, blocks or staging slots,
        # frozen pos/tok.
        self._handoff_counts = {
            "out_requests": 0, "out_blocks": 0, "in_requests": 0, "in_blocks": 0,
            "alias": 0, "dma": 0,
        }
        self._table = np.zeros((slots, self._table_cols), np.int32)

    # -- submission ------------------------------------------------------
    def submit(self, prompt: "list[int]", max_new: "int | None" = None,
               seed: "int | None" = None,
               stop_sequences: "list[list[int]] | None" = None, *,
               use_prefix_cache: bool = True, enqueued_at: "float | None" = None,
               priority: int = 0, trace_parent: "trace.TraceContext | None" = None) -> int:
        """Queue a request; returns its id.  Admission happens on `tick`.
        ``seed``: the request's sampling key (default: its id; greedy
        output does not depend on it).  ``stop_sequences``: token runs
        that end the request when generated (finish_reason ``"stop"``,
        the matched suffix kept in ``tokens``).  ``use_prefix_cache=False``
        opts the request out of the cache (no reuse, no parking).
        ``enqueued_at`` backdates the timeline's enqueue point (a
        ``perf_counter`` stamp, only ever moved earlier).  ``priority``:
        the admission head is the highest-priority waiting request.
        ``trace_parent``: the submitting tier's span context (a
        `trace.TraceContext`): the request's spans join that trace instead
        of opening one.  A bad request raises here, never mid-tick."""
        self._check_open()
        budget, stops = self.validate_request(prompt, max_new, seed, stop_sequences, priority)
        if trace_parent is not None and not isinstance(trace_parent, trace.TraceContext):
            raise ValueError(
                "trace_parent must be a utils.trace.TraceContext, got "
                f"{type(trace_parent).__name__}"
            )
        now = time.perf_counter()
        t0 = now if enqueued_at is None else min(float(enqueued_at), now)
        ctx = trace_parent.child() if trace_parent is not None else trace.TraceContext.new()
        req = Request(
            id=self._next_id, prompt=list(prompt), max_new=budget,
            seed=self._next_id if seed is None else seed, priority=priority,
            stop_sequences=stops, use_prefix_cache=bool(use_prefix_cache),
            submitted_at=t0, enqueued_at=t0, replica=self.name,
            trace_id=ctx.trace_id, trace_ctx=ctx, trace_parent=trace_parent,
        )
        self._next_id += 1
        self._queue.append(req)
        self._by_id[req.id] = req
        return req.id

    def validate_request(self, prompt: "list[int]", max_new: "int | None" = None,
                         seed: "int | None" = None,
                         stop_sequences: "list[list[int]] | None" = None,
                         priority: int = 0) -> "tuple[int, list[list[int]]]":
        """`submit`'s checks, without submitting; returns the budget and
        the stop sequences as lists.  A front end that may hold a request
        in its own queue validates here, at arrival."""
        for t in prompt:
            # A bool would embed as 0/1 and an out-of-range id would index
            # past the table: both must fail here.
            if isinstance(t, bool) or not isinstance(t, int) or not 0 <= t < self.config.vocab:
                raise ValueError(
                    f"prompt token ids must be ints in [0, {self.config.vocab}), got {t!r}"
                )
        if not 1 <= len(prompt) <= self.prompt_slots:
            raise ValueError(
                f"prompt length must be in [1, {self.prompt_slots}], got {len(prompt)}"
            )
        budget = self.max_new_cap if max_new is None else max_new
        if not 1 <= budget <= self.max_new_cap:
            raise ValueError(f"max_new must be in [1, {self.max_new_cap}], got {budget}")
        if seed is not None and not -(2**31) <= seed < 2**31:
            raise ValueError(f"seed must fit int32, got {seed}")
        if (
            isinstance(priority, bool)
            or not isinstance(priority, int)
            or not -(2**31) <= priority < 2**31
        ):
            raise ValueError(f"priority must be an int (int32 range), got {priority!r}")
        stops = [list(s) for s in (stop_sequences or [])]
        if any(not s for s in stops):
            raise ValueError("stop sequences must be non-empty")
        if any(not isinstance(t, int) or isinstance(t, bool) for s in stops for t in s):
            # A str would split into 1-char strings that never equal a
            # token, and a bool would equal token 0 or 1.
            raise ValueError("stop sequences must contain int token ids")
        return budget, stops

    # -- admission control -----------------------------------------------
    def _paged_demand(self, req: Request, use: int) -> "tuple[int, int]":
        """Worst-case fresh blocks to admit ``req`` with a usable resident
        prefix of ``use`` tokens: ``(need, total_cols)`` — its table
        columns minus the aliased full windows, plus the COW block when
        the prompt may park with a partial last block (one too many when
        the exact prompt is already resident: conservative, never
        optimistic)."""
        length = len(req.prompt)
        w = self.block_size
        total_cols = -(-(length + req.max_new) // w)
        cacheable = self._prefix is not None and req.use_prefix_cache
        cow = 1 if (cacheable and length >= w and length % w) else 0
        return total_cols - use // w + cow, total_cols

    def _ensure_admittable(self, req: Request) -> bool:
        """Block-demand admission control for the head, three rungs: it
        fits the free list; else trim the coldest unpinned prefix
        entry's tail block (`PagedPrefixCache.evict_one`); else preempt a
        strictly-lower-priority row to the host tier (`_try_preempt`).
        False parks the head.  Re-peeks after every rung: a trim can
        shrink the alias credit the demand counted on.  The rows layout
        has no blocks: a free row is all it needs."""
        if self._kv_layout != "paged":
            return True
        while True:
            if req.swapped:
                # Exact: the blocks it held, no alias credit, no COW.
                need = len(self._swap_state[req.id]["host_slots"])
            elif req.id in self._handoff_state:
                # Alias payloads own their blocks already; a dma payload
                # needs a block per staged slot.
                ho = self._handoff_state[req.id]
                need = 0 if ho["mode"] == "alias" else len(ho["slots"])
            else:
                use = (
                    self._prefix.peek(req.prompt, min_use=self.block_size)
                    if self._prefix is not None and req.use_prefix_cache
                    else 0
                )
                need, _ = self._paged_demand(req, use)
            if self._balloc.free_count >= need:
                return True
            if self._prefix is not None and self._prefix.evict_one(
                current_step=self._device_steps
            ):
                continue
            if self._try_preempt(req):
                continue
            return False

    def _try_preempt(self, req: Request) -> bool:
        """Swap one mid-decode row out to make room for ``req``.
        Candidates: rows whose request has strictly lower priority, has
        its first token (a row of the current wave is still in flight),
        and whose blocks fit the host tier's free slots; the victim
        policy picks among them.  False sends the caller to parking."""
        if self._host_pool.capacity == 0:
            return False
        records = None
        candidates = []
        for row, victim in enumerate(self._row_req):
            if victim is None or victim.priority >= req.priority or not victim.tokens:
                continue
            blocks = [int(b) for b in self._table[row] if b]
            if len(blocks) > self._host_pool.free_count:
                continue
            if records is None:
                records = {
                    r["block"]: r
                    for r in self._balloc.block_records(current_step=self._device_steps)
                }
            candidates.append(
                {"row": row, "priority": victim.priority, "blocks": blocks, "records": records}
            )
        if not candidates:
            return False
        free = {b for b in range(1, self._balloc.num_blocks) if self._balloc.refcount(b) == 0}
        row = self._swap_policy.pick(candidates, free_blocks=free,
                                     num_blocks=self._balloc.num_blocks)
        if row is None or self._row_req[row] is None:
            return False
        self._swap_out(row, by=req)
        return True

    # -- block copies to and from host memory ----------------------------
    def _fetch_blocks(self, blocks: "list[int]") -> list:
        """Host copies of ``blocks``, one `read_block` payload each: on a
        CUDA engine each leaf is copied into pinned memory on the pool's
        stream, then ONE sync ends them all (the payloads are complete
        before the caller lets the blocks go); on a CPU engine
        `read_block`'s copy already is the payload."""
        if self.device.type != "cuda":
            return [read_block(self._pool, b) for b in blocks]

        def to_host(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

        payloads = [_tree_map(to_host, read_block(self._pool, b)) for b in blocks]
        torch.cuda.current_stream(self.device).synchronize()
        return payloads

    def _restore_blocks(self, blocks: "list[int]", slots: "list[int]", host: HostBlockPool):
        """Write each host slot's payload into its block and free the
        slot.  The uploads are queued on the pool's stream without a
        sync; a freed slot's pinned buffer is not reused while its upload
        still reads it, because the caching host allocator records the
        copy's stream and holds the buffer until the copy has run."""
        for b, slot in zip(blocks, slots):
            write_block(self._pool, b, host.load(slot))
            host.free(slot)

    # -- swap -------------------------------------------------------------
    def _swap_out(self, row: int, by: Request) -> None:
        """Preempt row ``row``: copy its blocks to host slots, drop the
        table's references, zero the row onto scratch, release its
        prefix pins, and re-queue the request with its position and
        pending token frozen (`_swap_in` restores it bitwise)."""
        req = self._row_req[row]
        now = time.perf_counter()
        blocks = [int(b) for b in self._table[row] if b]
        host_slots = []
        for data in self._fetch_blocks(blocks):
            slot = self._host_pool.store(data)
            if slot is None:  # _try_preempt checked the headroom
                raise RuntimeError("host swap accounting violated: pool filled mid-swap")
            host_slots.append(slot)
        req.swap_dma_s += time.perf_counter() - now
        self._balloc.unref(blocks, step=self._device_steps)
        # Zero onto scratch before the blocks can be reallocated: the
        # frozen row keeps stepping.
        self._table[row, :] = 0
        for entry in self._row_pins[row]:
            self._prefix.release(entry)
        self._row_pins[row] = []
        self._swap_state[req.id] = {
            "host_slots": host_slots, "pos": self._pos[row], "tok": self._tok[row],
        }
        self._row_req[row] = None
        req.swapped = True
        req.preemptions += 1
        req.preempted_by.append(by.id)
        req.swap_out_blocks += len(blocks)
        req._swapped_at = now
        # Head selection orders by (priority, enqueued_at): the victim
        # resumes ahead of younger requests of its class.
        self._queue.append(req)
        self._swap_counts["out_blocks"] += len(blocks)
        self._swap_counts["preemptions"] += 1
        SERVE_KV_SWAPS.inc(len(blocks), engine=self.name, direction="out")
        if self.telemetry:
            trace.emit_span(
                "serve.swapout", parent=req.trace_ctx, start_unix_s=_unix_of(now),
                duration_s=time.perf_counter() - now, request=req.id, blocks=len(blocks),
                preempted_by=by.id,
                reason=f"preempted by request {by.id} (priority {by.priority} > {req.priority})",
            )

    def _swap_in(self, req: Request, row: int) -> None:
        """Restore a swapped-out request into free row ``row``: fresh
        blocks, each host payload written back, the table row rebuilt,
        position and pending token unfrozen.  The caller cleared the
        demand."""
        now = time.perf_counter()
        state = self._swap_state.pop(req.id)
        host_slots = state["host_slots"]
        own = self._balloc.alloc(len(host_slots), step=self._device_steps, origin="swapin")
        if own is None:
            raise RuntimeError(
                "swap-in accounting violated: demand was cleared but the allocator came up short"
            )
        self._restore_blocks(own, host_slots, self._host_pool)
        self._kv_counts["alloc_blocks"] += len(own)
        self._set_row(row, req, own, state["pos"], state["tok"])
        restored = time.perf_counter()
        req.swapped = False
        req.swapped_s += restored - req._swapped_at
        req.swap_dma_s += restored - now
        req.swap_in_blocks += len(own)
        # The parked stall is counted once, in swapped_s: the next token's
        # arrival gap starts here.
        req._last_token_at = restored
        self._swap_counts["in_blocks"] += len(own)
        self._swap_counts["in_requests"] += 1
        SERVE_KV_SWAPS.inc(len(own), engine=self.name, direction="in")
        if self.telemetry:
            trace.emit_span(
                "serve.swapin", parent=req.trace_ctx, start_unix_s=_unix_of(req._swapped_at),
                duration_s=restored - req._swapped_at, request=req.id, row=row,
                blocks=len(own), parked_s=round(restored - req._swapped_at, 6),
            )

    def _set_row(self, row: int, req: Request, cols: "list[int]", pos: int, tok: int) -> None:
        """Seat a restored request in ``row``: its table, its frozen
        position and pending token, no pins."""
        self._table[row, :] = 0
        self._table[row, :len(cols)] = cols
        self._row_req[row] = req
        self._row_pins[row] = []
        self._pos[row] = pos
        self._tok[row] = tok

    # -- handoff between engines -----------------------------------------
    def handoff_out(self, row: int, *, mode: str,
                    staging: "HostBlockPool | None" = None) -> "dict | None":
        """Ship row ``row``'s KV off this engine as a block-table payload
        for another engine's `handoff_in`.  ``mode="alias"`` moves the
        table's block references into the payload (only between engines
        sharing one allocator and pool dict); ``mode="dma"`` copies each
        block into ``staging`` and drops the references.  Returns the
        payload, or None when ``staging`` cannot hold the row (nothing
        stored, the row stays live).  The request leaves this engine: row
        freed, pins released, `request` forgets it."""
        self._check_open()
        if self._kv_layout != "paged":
            raise RuntimeError(
                "handoff_out needs kv_layout='paged': the handoff unit is a block table"
            )
        if mode not in ("alias", "dma"):
            raise ValueError(f"mode must be 'alias' or 'dma', got {mode!r}")
        if mode == "dma" and staging is None:
            raise ValueError("mode='dma' requires a staging HostBlockPool")
        req = self._row_req[row]
        if req is None:
            raise ValueError(f"row {row} holds no in-flight request")
        now = time.perf_counter()
        blocks = [int(b) for b in self._table[row] if b]
        payload = {
            "request": req, "mode": mode, "source": self.name,
            "pos": self._pos[row], "tok": self._tok[row],
        }
        if mode == "alias":
            # The references move with the payload: no unref, no copy.
            payload["blocks"] = blocks
        else:
            if staging.free_count < len(blocks):
                return None
            payload["slots"] = [staging.store(data) for data in self._fetch_blocks(blocks)]
            payload["staging"] = staging
            self._balloc.unref(blocks, step=self._device_steps)
        self._table[row, :] = 0
        for entry in self._row_pins[row]:
            self._prefix.release(entry)
        self._row_pins[row] = []
        self._row_req[row] = None
        self._by_id.pop(req.id, None)
        req.handoffs += 1
        req.handoff_blocks += len(blocks)
        req._handoff_at = now
        self._handoff_counts["out_requests"] += 1
        self._handoff_counts["out_blocks"] += len(blocks)
        if self.telemetry:
            # The prefill tier's span: admission to the row's departure.
            trace.emit_span(
                "prefill.run", parent=req.trace_ctx, start_unix_s=_unix_of(req.admitted_at),
                duration_s=now - req.admitted_at, request=req.id, blocks=len(blocks),
                mode=mode, prompt_len=len(req.prompt),
            )
        return payload

    def handoff_in(self, payload: dict) -> int:
        """Accept a `handoff_out` payload: adopt the request under a
        fresh local id, park its block table (or staged slots) and queue
        it; the next admission restores it (`_handoff_restore`) under the
        same block-demand gate as every head.  Returns the local id."""
        self._check_open()
        if self._kv_layout != "paged":
            raise RuntimeError(
                "handoff_in needs kv_layout='paged': the handoff unit is a block table"
            )
        req = payload["request"]
        mode = payload["mode"]
        cols = payload["blocks"] if mode == "alias" else payload["slots"]
        if len(cols) > self._table_cols:
            raise ValueError(
                f"handoff payload needs {len(cols)} blocks but this engine's table rows "
                f"hold {self._table_cols}"
            )
        req.id = self._next_id
        self._next_id += 1
        req.replica = self.name
        self._by_id[req.id] = req
        self._handoff_state[req.id] = {
            "mode": mode,
            "blocks": payload.get("blocks", []),
            "slots": payload.get("slots", []),
            "staging": payload.get("staging"),
            "source": payload["source"],
            "pos": payload["pos"],
            "tok": payload["tok"],
        }
        self._queue.append(req)
        return req.id

    def _handoff_restore(self, req: Request, row: int) -> None:
        """Rebuild a handed-in request in free row ``row``: alias mode
        adopts the payload's references into the table (no device
        touch); dma mode writes each staged payload into fresh blocks.
        The caller cleared the demand."""
        state = self._handoff_state.pop(req.id)
        mode = state["mode"]
        if mode == "alias":
            cols = list(state["blocks"])
            self._kv_counts["alias_blocks"] += len(cols)
            SERVE_KV_ALIAS.inc(len(cols), engine=self.name)
        else:
            cols = self._balloc.alloc(len(state["slots"]), step=self._device_steps,
                                      origin="handoff")
            if cols is None:
                raise RuntimeError(
                    "handoff accounting violated: demand was cleared but the allocator "
                    "came up short"
                )
            self._restore_blocks(cols, state["slots"], state["staging"])
            self._kv_counts["alloc_blocks"] += len(cols)
        self._set_row(row, req, cols, state["pos"], state["tok"])
        restored = time.perf_counter()
        req.handoff_s += restored - req._handoff_at
        req.handoff_mode = mode
        req._last_token_at = restored
        self._handoff_counts[mode] += 1
        self._handoff_counts["in_requests"] += 1
        self._handoff_counts["in_blocks"] += len(cols)
        DISAGG_HANDOFFS.inc(engine=self.name, mode=mode)
        DISAGG_HANDOFF_BLOCKS.inc(len(cols), engine=self.name, mode=mode)
        if self.telemetry:
            trace.emit_span(
                f"handoff.{mode}", parent=req.trace_ctx, start_unix_s=_unix_of(req._handoff_at),
                duration_s=restored - req._handoff_at, request=req.id, row=row,
                blocks=len(cols), source=state["source"], target=self.name,
            )

    # -- the engine loop -------------------------------------------------
    def _admit_paged(self, req: Request, row: int):
        """One paged admission: match -> alias the window-aligned prefix
        blocks -> allocate the rest -> prefill the windows from the first
        unaliased one -> park the prompt as an entry -> COW the shared
        partial last block.  Returns ``(last, pins)``: the logits at the
        prompt's last position (1, vocab), left on the device, and the
        entries the row pins.  The caller cleared the demand."""
        w = self.block_size
        length = len(req.prompt)
        cacheable = self._prefix is not None and req.use_prefix_cache
        entry, m, m_raw = (
            self._prefix.match(req.prompt, min_use=w) if cacheable else (None, 0, 0)
        )
        pins = []
        total_cols = -(-(length + req.max_new) // w)
        fw = 0
        cols: "list[int]" = []
        if entry is not None:
            self._prefix.acquire(entry)
            pins.append(entry)
            # Alias only whole windows: the first computed window starts
            # on the grid, so reused == positions whose compute was skipped.
            fw = m // w
            cols = list(entry.blocks[:fw])
            self._balloc.ref(cols, step=self._device_steps)
            self._kv_counts["alias_blocks"] += fw
            SERVE_KV_ALIAS.inc(fw, engine=self.name)
            req.prefix_reused = fw * w
            SERVE_PREFILL_TOKENS.inc(fw * w, kind="reused")
        SERVE_PREFILL_TOKENS.inc(length - fw * w, kind="computed")
        self._prefill_tokens["reused"] += fw * w
        self._prefill_tokens["computed"] += length - fw * w
        own = self._balloc.alloc(total_cols - fw, step=self._device_steps)
        if own is None:  # _ensure_admittable holds this invariant
            raise RuntimeError(
                "paged admission accounting violated: demand was cleared "
                "but the allocator came up short"
            )
        cols += own
        self._kv_counts["alloc_blocks"] += len(own)
        self._table[row, :] = 0
        self._table[row, :total_cols] = cols
        # The windows before fw are aliased and never written.
        with trace.range(_PREFILL_RANGE):
            last = self._prefill_into(self._prompt_stage[row], req.prompt, self._table[row], fw)
            self._model.admitted(row, length)
        if cacheable and length >= w and (m_raw < length or entry is None or entry.length < length):
            # Park the prompt's blocks, unless the exact prompt is already
            # resident at full length or is shorter than a window; a
            # trimmed entry of this very prompt re-extends here.
            prompt_cols = -(-length // w)
            new_entry = self._prefix.insert(req.prompt, cols[:prompt_cols])
            if new_entry is not None:
                pins.append(new_entry)
                if length % w:
                    # COW: the partial last prompt block is now shared and
                    # the first decode token will write into it: the table
                    # gets a private copy, the entry keeps the original.
                    lb = prompt_cols - 1
                    nb = self._balloc.alloc(1, step=self._device_steps, origin="cow")
                    if nb is None:
                        raise RuntimeError(
                            "paged admission accounting violated: no block left for the COW copy"
                        )
                    copy_block(self._pool, nb[0], cols[lb])
                    self._balloc.unref([cols[lb]], step=self._device_steps)
                    self._table[row, lb] = nb[0]
                    self._kv_counts["cow_blocks"] += 1
                    SERVE_KV_COW.inc(engine=self.name)
        req.kv_blocks = total_cols
        return last, pins

    def _upload(self, stage: torch.Tensor, prompt: "list[int]", table_row=None, out=None):
        """ONE upload of ``stage`` (a staging row: the padded prompt, the
        table row on paged, the length) without a host sync, into a new
        device tensor or into ``out`` (a device buffer of its layout).
        Returns the device's ``(prompt (1, prompt_slots), lens (1,),
        table (1, cols))``."""
        P = self.prompt_slots
        host = stage.numpy()
        host[:] = 0
        host[:len(prompt)] = prompt
        if table_row is not None:
            host[P:P + self._table_cols] = table_row
        host[-1] = len(prompt)
        if out is None:
            staged = stage.to(self.device, non_blocking=True)
        else:
            staged = out.copy_(stage, non_blocking=True)
        return staged[None, :P], staged[-1:], staged[None, P:P + self._table_cols]

    def _capture(self) -> None:
        """The one place that captures: on one CUDA device without a mesh,
        the model's prefill windows unless this is a decode tier, its step
        unless a prefill tier (`paged.PartGraphs`), on the pool as it is
        now.  The inputs, views of a staging buffer (``st["staged"]``) and
        of ``_state``, are zeros: the warm-up writes scratch alone, and
        counts no kernel launch.  Code that rebinds the pool calls it
        again (`DisaggServer`'s alias tiers): the graphs address the pool
        they were captured on."""
        self._prefill_graphs = self._step_graphs = None  # the old graphs' memory first
        if self.mesh is not None or self.device.type != "cuda":
            return
        model, dev, cols = self._model, self.device, self._table_cols
        with model.kernel.uncounted():
            if self.tier != "decode":
                P = self.prompt_slots
                staged = torch.zeros(P + cols + 1, dtype=torch.int32, device=dev)
                st = {"staged": staged, "prompt": staged[None, :P], "lens": staged[-1:],
                      "table": staged[None, P:P + cols],
                      "last": torch.zeros((1, self.config.vocab), device=dev)}
                self._prefill_graphs = PartGraphs(
                    model.prefill_parts(self.params, self._pool, st), st)
            if self.tier != "prefill":
                B, state = self.slots, self._state.zero_()
                st = {"tok": state[:B], "pos": state[B:2 * B],
                      "table": state[4 * B:].view(B, cols)}
                self._step_graphs = PartGraphs(
                    model.decode_parts(self.params, self._pool, self.attn_backend), st)
        model.captured()

    def _prefill_into(self, stage: torch.Tensor, prompt: "list[int]", table_row,
                      first_window: int) -> torch.Tensor:
        """Prefill ``prompt`` into the blocks ``table_row`` names, from
        window ``first_window`` on, through ONE upload of ``stage``:
        replayed from the captured windows where the engine has them
        (``last`` zeroed first and copied after: the next admission's
        replay rewrites it before a wave reads it), launched op by op
        elsewhere.  Returns the logits at the prompt's last position."""
        graphs = self._prefill_graphs
        if graphs is not None:
            self._upload(stage, prompt, table_row, out=graphs.st["staged"])
            graphs.st["last"].zero_()
            last, path = graphs.replay(first_window)["last"].clone(), "graph"
        else:
            tokens, lens, table = self._upload(stage, prompt, table_row)
            last, self._pool = self._prefill(self.params, tokens, lens, self._pool, table,
                                             first_window=first_window)
            path = "eager"
        windows = self.prompt_slots // self.block_size - first_window
        self._prefill_windows[path] += windows
        SERVE_PREFILL_WINDOWS.inc(windows, path=path)
        return last

    def _prefill_row(self, stage: torch.Tensor, prompt: "list[int]"):
        """A B=1 cache holding ``prompt``'s prefill (padded to
        ``prompt_slots``, one pass), through ONE upload of ``stage``.
        Returns ``(cache1, last)``, ``last`` the logits at the prompt's
        last position, on the device."""
        tokens, lens, _ = self._upload(stage, prompt)
        cache1 = init_cache(self.config, 1, self.kv_int8, device=self.device, mesh=self.mesh)
        last, cache1 = self._prefill1(self.params, tokens, lens, cache1)
        return cache1, last

    def _admit_rows(self, req: Request, row: int):
        """One rows admission: the prompt's B=1 prefill — with a prefix
        hit, the window-aligned prefix copied from the pool row into a
        fresh B=1 cache and only the windows after it computed — its KV
        parked in a pool row for later hits (unless the exact prompt is
        resident or shorter than a window), then the whole B=1 row copied
        into engine row ``row`` (every position: the row's previous
        tenant is overwritten).  Returns ``(last, pins)`` as
        `_admit_paged` does."""
        length = len(req.prompt)
        w = self.block_size
        stage = self._prompt_stage[row]
        cacheable = self._prefix is not None and req.use_prefix_cache
        entry, m, m_raw = (
            self._prefix.match(req.prompt, min_use=w) if cacheable else (None, 0, 0)
        )
        pins = []
        if entry is not None:
            self._prefix.acquire(entry)
            pins.append(entry)
            # Copy only whole windows: the first computed window starts
            # on the grid, so reused == positions whose compute was skipped.
            fw = m // w
            tokens, lens, _ = self._upload(stage, req.prompt)
            cache1 = init_cache(self.config, 1, self.kv_int8, device=self.device, mesh=self.mesh)
            copy_prefix_into_row(cache1, 0, self._prefix.pool, entry.slot, fw * w)
            with trace.range(_PREFILL_RANGE):
                last, cache1 = self._suffix(self.params, tokens, lens, cache1, first_window=fw)
            req.prefix_reused = fw * w
            SERVE_PREFILL_TOKENS.inc(fw * w, kind="reused")
        else:
            with trace.range(_PREFILL_RANGE):
                cache1, last = self._prefill_row(stage, req.prompt)
        SERVE_PREFILL_TOKENS.inc(length - req.prefix_reused, kind="computed")
        self._prefill_tokens["reused"] += req.prefix_reused
        self._prefill_tokens["computed"] += length - req.prefix_reused
        if cacheable and m_raw < length and length >= w:
            new_entry = self._prefix.insert(req.prompt)
            if new_entry is not None:
                copy_prefix_into_row(self._prefix.pool, new_entry.slot, cache1, 0, length)
                pins.append(new_entry)
        local = self._own_row(row)
        if local is not None:  # on a mesh, only the row's owner holds it
            copy_prefix_into_row(self._cache, local, cache1, 0, self.config.seq)
        return last, pins

    def _own_row(self, row: int) -> "int | None":
        """Engine row ``row``'s index in this rank's rows cache, or None
        when another rank holds it."""
        rows = self._rows
        if rows is None:
            return row
        return row - rows.lo if rows.lo <= row < rows.hi else None

    def _head_index(self) -> int:
        """The admission head's queue index: highest priority first,
        earliest enqueue among equals (a swapped-out victim keeps its
        original stamp, so it resumes ahead of younger equals)."""
        best = 0
        for i in range(1, len(self._queue)):
            r, b = self._queue[i], self._queue[best]
            if (r.priority, -r.enqueued_at) > (b.priority, -b.enqueued_at):
                best = i
        return best

    def _admit(self) -> "tuple[int, int]":
        """Fill free rows from the queue, head first, while the head's
        block demand clears `_ensure_admittable`; returns ``(admitted,
        prefix_hits)`` for the tick's step record.  A swapped-out or
        handed-in head is restored instead and joins no wave (its next
        token is frozen on the host).  The wave's first tokens come back
        in ONE fetch.  The whole call is the tick's admit phase, and its
        ``engine.admit`` range."""
        with trace.range(_PHASE_RANGE["admit"]):
            return self._admit_wave()

    def _admit_wave(self) -> "tuple[int, int]":
        t_phase = time.perf_counter()
        # (row, last logits, admitted at, own admission's seconds)
        wave: "list[tuple[int, torch.Tensor, float, float]]" = []
        hits = 0
        while self._queue and any(r is None for r in self._row_req):
            head = self._head_index()
            if not self._ensure_admittable(self._queue[head]):
                break
            # Scan for the row after admission control: a preemption may
            # have freed a lower-numbered one.
            row = self._row_req.index(None)
            req = self._queue.pop(head)
            if req.swapped:
                self._swap_in(req, row)
                continue
            if req.id in self._handoff_state:
                self._handoff_restore(req, row)
                continue
            t_admit = time.perf_counter()
            req.admitted_at = t_admit
            req.queue_wait_s = t_admit - req.enqueued_at
            SERVE_QUEUE_WAIT_SECONDS.observe(req.queue_wait_s)
            if self.telemetry:
                trace.emit_span(
                    "serve.queue", parent=req.trace_ctx, start_unix_s=_unix_of(req.enqueued_at),
                    duration_s=req.queue_wait_s, request=req.id, queue_depth=len(self._queue),
                )
            if self._kv_layout == "paged":
                last, pins = self._admit_paged(req, row)
            else:
                last, pins = self._admit_rows(req, row)
            prefill_s = time.perf_counter() - t_admit
            self._row_req[row] = req
            self._pos[row] = len(req.prompt)
            self._row_pins[row] = pins
            wave.append((row, last[0], t_admit, prefill_s))
            hits += req.prefix_reused > 0
        if wave:
            rows = [row for row, *_ in wave]
            logits = torch.stack([last for _, last, *_ in wave])
            seeds = positions = None
            if self._sampled:
                # A request's first token lands in position len(prompt).
                host = self._wave_stage.numpy()
                n = len(wave)
                host[:n] = [self._row_req[r].seed for r in rows]
                host[n:2 * n] = [self._pos[r] for r in rows]
                staged = self._wave_stage[:2 * n].to(self.device, non_blocking=True)
                seeds, positions = staged[:n], staged[n:]
            toks = self._sample(logits, seeds, positions)
            # One fetch for the whole wave: its tokens and their logprobs.
            fetched = self._fetch(
                [toks], [_chosen_logprob(logits, toks)] if self.with_logprobs else []
            )
            for i, (row, _, t_admit, prefill_s) in enumerate(wave):
                req = self._row_req[row]
                self._tok[row] = fetched[0][0][i]
                self._note_token(row, fetched[0][0][i], fetched[1][0][i])
                if self.telemetry:
                    trace.emit_span(
                        "serve.admit", parent=req.trace_ctx, start_unix_s=_unix_of(t_admit),
                        duration_s=time.perf_counter() - t_admit, request=req.id, row=row,
                        prompt_len=len(req.prompt), prefix_hit=req.prefix_reused > 0,
                        prefix_reused=req.prefix_reused,
                        suffix_len=len(req.prompt) - req.prefix_reused,
                        prefill_s=prefill_s,
                        wave_wait_s=req.first_token_at - t_admit - prefill_s,
                    )
        self._phase_acc["admit"] += time.perf_counter() - t_phase
        return len(wave), hits

    def _sample(self, logits, seeds, positions):
        """The next token of every row of ``logits`` (B, vocab): greedy,
        or drawn under each row's key ``fold_in(key(seed), position)``."""
        if not self._sampled:
            return self._pick(logits)
        return self._pick(logits, prng.fold_in(prng.key(seeds), positions))

    def _global_picks(self, toks, lps):
        """A mesh step's picks (and logprobs) of the rank's group's rows
        made every row's, in one all-gather over ``data``: a token id (at
        most the vocabulary, far below 2**24) is exact in f32 beside its
        logprob.  The identity on one device or a replicated batch."""
        rows = self._rows
        if rows is None or not rows.split:
            return toks, lps
        if lps is None:
            return rows.to_global(toks), None
        both = rows.to_global(torch.stack([toks.to(torch.float32), lps], dim=1))
        return both[:, 0].to(torch.int32), both[:, 1]

    def _fetch(self, ints, floats):
        """ONE blocking device-to-host copy of the int tensors ``ints``
        and, on a logprob engine, the f32 tensors ``floats`` (each a
        stack of (B,) rows): returns ``(ints, floats)`` as nested lists,
        ``floats`` zeros without logprobs.  float64 carries both exactly."""
        a = torch.stack(ints)
        if not self.with_logprobs:
            got = a.tolist()
            return got, [[0.0] * len(got[0])] * len(got)
        b = torch.stack(floats)
        got = torch.cat([a.double(), b.double()]).tolist()
        return [[int(v) for v in r] for r in got[:len(ints)]], got[len(ints):]

    def _note_token(self, row: int, token: int, logprob: float = 0.0) -> None:
        req = self._row_req[row]
        now = time.perf_counter()
        req.tokens.append(token)
        if len(req.tokens) == 1:
            req.first_token_at = now
            req.ttft_s = now - req.submitted_at
            SERVE_TTFT_SECONDS.observe(req.ttft_s)
            if self.ttft_slo_s is not None:
                verdict = "met" if req.ttft_s <= self.ttft_slo_s else "missed"
                req.slo["ttft"] = verdict
                SERVE_SLO_TOTAL.inc(slo="ttft", verdict=verdict)
        else:
            delta = now - req._last_token_at
            req.token_deltas.append(delta)
            if self.telemetry:
                SERVE_TPOT_SECONDS.observe(delta)
        req._last_token_at = now
        self._tokens_emitted += 1
        if self.with_logprobs:
            req.logprobs.append(logprob)
        if self.eos_token is not None and token == self.eos_token:
            req.done, req.finish_reason = True, "eos"
        elif any(req.tokens[-len(s):] == s for s in req.stop_sequences):
            req.done, req.finish_reason = True, "stop"
        elif len(req.tokens) >= req.max_new:
            req.done, req.finish_reason = True, "budget"
        if req.done:
            self._finish(row, req, now)

    def _finish(self, row: int, req: Request, now: float) -> None:
        """Close out a finished request: its TPOT and SLO verdicts, the
        serve.decode and serve.request spans, its waterfall record
        (`obs.requests.observe_finished`), then its row: on paged, drop the table's block references and point the
        row at scratch, so its frozen writes can never reach a block a
        later admission reallocates (blocks a resident entry holds stay
        allocated); release its pins.  A rows slot is left as it is: the
        next admission's insert overwrites the whole row."""
        req.finished_at = now
        if req.token_deltas:
            req.tpot_s = sum(req.token_deltas) / len(req.token_deltas)
            if self.tpot_slo_s is not None:
                verdict = "met" if req.tpot_s <= self.tpot_slo_s else "missed"
                req.slo["tpot"] = verdict
                SERVE_SLO_TOTAL.inc(slo="tpot", verdict=verdict)
        if self.ttft_slo_s is not None or self.tpot_slo_s is not None:
            # Every evaluated target met (a one-token request under a
            # tpot-only target has none evaluated, and counts as met).
            verdict = "missed" if "missed" in req.slo.values() else "met"
            req.slo["request"] = verdict
            SERVE_SLO_TOTAL.inc(slo="request", verdict=verdict)
            if verdict == "met":
                self._slo_met += 1
            else:
                self._slo_missed += 1
        if self.telemetry:
            trace.emit_span(
                "serve.decode", parent=req.trace_ctx, start_unix_s=_unix_of(req.first_token_at),
                duration_s=req.finished_at - req.first_token_at, request=req.id,
                tokens=len(req.tokens), finish_reason=req.finish_reason,
                tpot_s=round(req.tpot_s, 6) if req.token_deltas else None,
            )
            # The request's own span, emitted last: its identity is the
            # request's context, so the spans above parent to it; it
            # parents under the submitting tier's span when there was one.
            trace.emit_span(
                "serve.request", context=req.trace_ctx, parent=req.trace_parent,
                start_unix_s=_unix_of(req.enqueued_at),
                duration_s=req.finished_at - req.enqueued_at, request=req.id,
                prompt_len=len(req.prompt), tokens=len(req.tokens),
                finish_reason=req.finish_reason, queue_wait_s=round(req.queue_wait_s, 6),
                ttft_s=round(req.ttft_s, 6), prefix_reused=req.prefix_reused,
                slo=req.slo.get("request"),
            )
        obsreq.observe_finished(req)
        self._done.append(req)
        self._row_req[row] = None
        self._model.finished(row, req)
        if self._kv_layout == "paged":
            self._balloc.unref([int(b) for b in self._table[row] if b], step=self._device_steps)
            self._table[row, :] = 0
        for entry in self._row_pins[row]:
            self._prefix.release(entry)
        self._row_pins[row] = []

    def _step_once(self) -> None:
        """One device call (``_steps_per_call`` decode steps for every row,
        tokens and positions fed forward on the device, the active mask
        fixed at the call's start), its single blocking fetch, and the
        host-side token processing.  A row whose request finished at an
        earlier step of the same call burns the call's remaining steps:
        each is counted in `wasted_steps` and its token dropped.  The
        phases: dispatch runs to the blocking fetch, fetch to its end,
        host to the end of the token processing."""
        if self._profile_left > 0 and self._profiler is None:
            self._start_profile()
        t0 = time.perf_counter()
        with trace.range(_PHASE_RANGE["dispatch"]):
            n = self._steps_per_call
            self._device_steps += n
            B = self.slots
            stepped = [r is not None for r in self._row_req]
            stage = self._stage.numpy()
            stage[:B] = self._tok
            stage[B:2 * B] = self._pos
            stage[2 * B:3 * B] = stepped
            stage[3 * B:4 * B] = [r.seed if r is not None else 0 for r in self._row_req]
            paged = self._kv_layout == "paged"
            if paged:
                stage[4 * B:] = self._table.reshape(-1)
            state = self._state.copy_(self._stage, non_blocking=True)
            tok, pos = state[:B], state[B:2 * B]
            live = state[2 * B:3 * B].bool()
            seeds = state[3 * B:4 * B]
            table = state[4 * B:].view(B, self._table_cols)
            rows = self._rows
            toks, lps = [], []
            for _ in range(n):
                if paged:
                    logits, path = self._decode_paged(tok, table, pos)
                else:
                    # A row that walks past the context in a fused call
                    # writes its own last slot (`_step_rows` clamps).
                    logits, self._cache = _step_rows(self.params, tok, self._cache, pos,
                                                     self.config, rows)
                    path = "eager"
                self._decode_steps[path] += 1
                SERVE_DECODE_STEPS.inc(path=path)
                # The token fed at position pos lands in pos + 1.  On a mesh
                # the logits are the rank's group's rows.
                ahead = pos + 1
                if rows is not None:
                    nxt = self._sample(logits, rows.group(seeds), rows.group(ahead))
                else:
                    nxt = self._sample(logits, seeds, ahead)
                lp = _chosen_logprob(logits, nxt) if self.with_logprobs else None
                nxt, lp = self._global_picks(nxt, lp)
                if self.with_logprobs:
                    lps.append(lp)
                # Frozen rows keep their token and position, so their harmless
                # writes stay on one stale slot of scratch block 0.
                tok = torch.where(live, nxt, tok)
                pos = torch.where(live, pos + 1, pos)
                toks.append(tok)
        t1 = time.perf_counter()
        self._phase_acc["dispatch"] += t1 - t0
        # ONE blocking fetch per call: every step's tokens and logprobs,
        # and the final positions, together.
        with trace.range(_PHASE_RANGE["fetch"]):
            ints, floats = self._fetch(toks + [pos], lps)
        t2 = time.perf_counter()
        self._phase_acc["fetch"] += t2 - t1
        with trace.range(_PHASE_RANGE["host"]):
            self._tok = ints[n - 1]
            self._pos = ints[n]
            for s in range(n):
                for row in range(B):
                    if self._row_req[row] is None:
                        if stepped[row]:
                            # Stepped on after its request finished earlier
                            # in this call: compute spent, token dropped.
                            self._wasted_steps += 1
                            SERVE_WASTED_STEPS.inc(engine=self.name)
                        continue
                    self._note_token(row, ints[s][row], floats[s][row])
        self._phase_acc["host"] += time.perf_counter() - t2
        if self._profiler is not None:
            self._profile_left -= 1
            if self._profile_left <= 0:
                self._stop_profile()

    def _decode_paged(self, tok, table, pos):
        """One paged decode step, replayed from the captured step (static
        logits, valid until the next replay; the kernel's launches
        counted) or the model's step op by op (on a mesh, the rank's fsdp
        group's rows).  Returns ``(logits, path)``."""
        graphs = self._step_graphs
        if graphs is None:
            logits, self._pool = self._model.decode(self.params, tok, self._pool, table, pos,
                                                    self.attn_backend, rows=self._rows)
            return logits, "eager"
        logits = graphs.replay(tok=tok, table=table, pos=pos)["logits"]
        if self.attn_backend == "cuda":
            self._model.kernel.note_replays(self.config.n_layers)
        return logits, "graph"

    def tick(self) -> "list[Request]":
        """Admit waiting requests into free rows, then run
        ``steps_per_tick`` decode steps: one device call each with
        join/leave between them under ``"continuous"``, one fused call
        under ``"tick"`` (none on a prefill-tier engine: its admitted rows
        wait, frozen, for `handoff_out`, and a one-token request finished
        in its admission wave).  Returns the requests completed during
        this tick.  The tick's wall time is split into busy and idle
        seconds by occupancy (`capacity_snapshot`); with telemetry on it
        also appends one `servestats.StepRecord`.  Under a profiler the
        tick is the ``engine.tick`` range."""
        self._check_open()
        with trace.range(_TICK_RANGE):
            return self._tick()

    def _tick(self) -> "list[Request]":
        t0 = time.perf_counter()
        for p in self._phase_acc:
            self._phase_acc[p] = 0.0
        done_before = len(self._done)
        toks_before = self._tokens_emitted
        paged = self._kv_layout == "paged"
        preempt_before = self._swap_counts["preemptions"] if paged else 0
        swapin_before = self._swap_counts["in_requests"] if paged else 0
        admitted, prefix_hits = self._admit()
        # Occupancy and queue as the tick's first device call sees them.
        occupancy = sum(r is not None for r in self._row_req)
        queue_depth = len(self._queue)
        if self.tier == "prefill":
            calls = 0
        else:
            calls = self.steps_per_tick if self.scheduling == "continuous" else 1
        for s in range(calls):
            if s:
                a, h = self._admit()
                admitted += a
                prefix_hits += h
            if all(r is None for r in self._row_req):
                break
            self._step_once()
        finished = self._done[done_before:]
        # Stamped before the records below, so the phases divide the tick
        # they tile.
        step_wall = time.perf_counter() - t0
        frac = min(1.0, occupancy / self.slots)
        self._cap_busy_s += step_wall * frac
        self._cap_idle_s += step_wall * (1.0 - frac)
        self._cap_steps += 1
        if occupancy > 0:
            self._cap_last_step_mono = time.monotonic()
        if self.telemetry:
            phases = dict(self._phase_acc)
            for p, v in phases.items():
                if v > 0.0:
                    SERVE_STEP_PHASE_SECONDS.observe(v, engine=self.name, phase=p)
            if paged and (admitted or finished):
                # The free-run scan is O(pool): every 8th tick that changed
                # the pool's shape, the first one included.
                if self._kv_frag_ticks % 8 == 0:
                    for run in self._balloc.free_runs():
                        SERVE_KV_FREE_RUN_BLOCKS.observe(run, engine=self.name)
                self._kv_frag_ticks += 1
            servestats.RECORDER.record(servestats.StepRecord(
                engine=self.name, occupancy=occupancy, slots=self.slots,
                queue_depth=queue_depth, admitted=admitted, prefix_hits=prefix_hits,
                finished=len(finished), tokens=self._tokens_emitted - toks_before,
                step_wall_s=step_wall, phase_s=phases,
                preempted=self._swap_counts["preemptions"] - preempt_before if paged else 0,
                swapped_in=self._swap_counts["in_requests"] - swapin_before if paged else 0,
                slo_met=self._slo_met, slo_missed=self._slo_missed,
            ))
        return finished

    # -- the deep profiler -----------------------------------------------
    def profile_steps(self, n: int, trace_dir: "str | None" = None) -> str:
        """Capture the next ``n`` device calls under `torch.profiler`
        (the card's kernels too on a CUDA engine) and write them as a
        Chrome trace, ``<name>.pt.trace.json``, into ``trace_dir`` (a
        fresh temporary directory when omitted), which is returned.  The
        capture starts at the next device call and stops by itself after
        ``n`` of them (`profiling` tells whether one is armed); a profiler
        failure lands in `profile_error`, never in the serving loop.  One
        capture at a time."""
        self._check_open()
        if n < 1:
            raise ValueError(f"profile_steps needs n >= 1, got {n}")
        if self._profile_left > 0:
            raise RuntimeError("a step profile is already armed; wait for it to finish")
        if trace_dir is None:
            import tempfile

            trace_dir = tempfile.mkdtemp(prefix=f"tpudra-profile-{self.name}-")
        self._profile_dir = trace_dir
        self._profile_error = ""
        self._profile_left = n
        return trace_dir

    @property
    def profiling(self) -> bool:
        """True while a `profile_steps` capture is armed or running."""
        return self._profile_left > 0

    @property
    def profile_error(self) -> str:
        """The last profiler start or stop failure ("" when healthy)."""
        return self._profile_error

    @property
    def profile_path(self) -> str:
        """Where `profile_steps` writes its trace."""
        return os.path.join(self._profile_dir, f"{self.name}.pt.trace.json")

    def _start_profile(self) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            self._profiler = prof
        except Exception as e:
            self._profile_error = f"{type(e).__name__}: {e}"
            self._profile_left = 0

    def _stop_profile(self) -> None:
        prof, self._profiler = self._profiler, None
        self._profile_left = 0
        try:
            prof.stop()
            os.makedirs(self._profile_dir, exist_ok=True)
            prof.export_chrome_trace(self.profile_path)
        except Exception as e:
            self._profile_error = f"{type(e).__name__}: {e}"

    def run(self, until_idle: int = 10_000) -> "list[Request]":
        """Tick until queue and rows are empty; returns all completed
        requests in completion order.  ``until_idle`` bounds the loop."""
        for _ in range(until_idle):
            if not self.pending:
                break
            self.tick()
        else:
            raise RuntimeError("engine did not drain within the tick bound")
        return self._done

    # -- warm restart ----------------------------------------------------
    def export_prefix_index(self) -> dict:
        """The prefix cache's radix index as plain JSON-able data: token
        runs, hit counts and recency, hottest first; no KV.  A restarted
        engine passes it to `warm_start`.  Readable after `close`."""
        if self._prefix is None:
            raise ValueError(
                "engine has no prefix cache (prefix_cache_slots=0): nothing to checkpoint"
            )
        return {
            "version": 1,
            "prefix_window": self.block_size,
            "entries": self._prefix.export_index(),
        }

    def warm_start(self, index: dict, *, top_k: "int | None" = None) -> int:
        """Rebuild prefix-cache residency from an exported index before
        any traffic: re-prefill the ``top_k`` hottest runs (at most the
        cache's entry count) into fresh blocks and park each as an entry,
        its hit count seeded from the index.  The KV is recomputed from
        the weights, so a warm engine's tokens equal a cold one's.  Runs
        that no longer fit (shorter than a window, longer than
        ``prompt_slots``, a token out of vocabulary) are skipped; warming
        stops when the pool is full.  Returns the runs warmed."""
        self._check_open()
        if self._prefix is None:
            raise ValueError("engine has no prefix cache (prefix_cache_slots=0): cannot warm-start")
        if self._queue or any(r is not None for r in self._row_req):
            raise RuntimeError(
                "warm_start must run before admitting traffic (queue and rows must be empty)"
            )
        entries = list(index.get("entries") or ())
        entries.sort(key=lambda e: (-e.get("hits", 0), -e.get("last_used", 0)))
        # More than the entry cap would evict warmed hot runs for colder ones.
        budget = (self._prefix.pool_slots if top_k is None
                  else min(top_k, self._prefix.pool_slots))
        w = self.block_size
        warmed = 0
        for item in entries:
            if warmed >= budget:
                break
            tokens = item.get("tokens") or []
            if (
                not isinstance(tokens, list)
                or not w <= len(tokens) <= self.prompt_slots
                or any(isinstance(t, bool) or not isinstance(t, int)
                       or not 0 <= t < self.config.vocab for t in tokens)
            ):
                continue
            # Each run gets its own staging buffer, so no upload can see
            # the next run's values (the caching host allocator keeps a
            # freed buffer until its copy has run).
            stage = torch.zeros(self._prompt_stage.shape[1], dtype=torch.int32,
                                pin_memory=self.device.type == "cuda")
            if self._kv_layout == "paged":
                cols = -(-len(tokens) // w)
                while self._balloc.free_count < cols and self._prefix.evict_one():
                    pass
                own = self._balloc.alloc(cols)
                if own is None:
                    break  # the pool is held by pinned entries
                # A transient table row: no engine row is involved.
                table_row = np.zeros((self._table_cols,), np.int32)
                table_row[:cols] = own
                self._prefill_into(stage, tokens, table_row, 0)
                entry = self._prefix.insert(tokens, own)
                self._balloc.unref(own)  # the entry holds the blocks now
            else:
                entry = self._prefix.insert(tokens)
                if entry is not None:
                    cache1, _ = self._prefill_row(stage, tokens)
                    copy_prefix_into_row(self._prefix.pool, entry.slot, cache1, 0, len(tokens))
            if entry is None:
                break  # the entry cap is reached with every entry pinned
            entry.hits = int(item.get("hits", 0))
            self._prefix.release(entry)  # insert pins; nothing decodes
            self._prefill_tokens["computed"] += len(tokens)
            SERVE_PREFILL_TOKENS.inc(len(tokens), kind="computed")
            warmed += 1
        return warmed

    def prefix_digest(self) -> ReplicaDigest:
        """The resident prefixes as a `fleet.digest.ReplicaDigest`: the
        hashed window-aligned prefixes of `export_prefix_index`'s runs,
        which a fleet router matches prompts against.  An engine without
        a cache gives an empty digest.  Readable after `close`."""
        if self._prefix is None:
            return empty_digest(self.name)
        return build_digest(self.export_prefix_index(), replica=self.name,
                            epoch=self._prefix.epoch)

    # -- introspection ---------------------------------------------------
    def request(self, rid: int) -> "Request | None":
        """The Request of a submitted id (queued, mid-decode or finished);
        None for unknown ids and for requests handed off elsewhere."""
        return self._by_id.get(rid)

    def request_routes(self, rid: int):
        """The chosen experts at every position request ``rid`` has fed,
        (positions, moe layers, k) on the device, for an engine built
        with ``record_routes``: ``Request.routes`` once it finished, a
        copy of its row's record while it decodes; None otherwise."""
        req = self._by_id.get(rid)
        if req is None or req.routes is not None:
            return None if req is None else req.routes
        for row, q in enumerate(self._row_req):
            if q is req:
                return self._model.fed_routes(row, req)
        return None

    @property
    def replica_id(self) -> str:
        """The engine's identity as a fleet replica: its ``name``."""
        return self.name

    @property
    def slo_counts(self) -> "tuple[int, int]":
        """(met, missed) request-SLO verdict totals."""
        return self._slo_met, self._slo_missed

    @property
    def prefix_epoch(self) -> int:
        """The prefix cache's residency epoch (bumped on every insert,
        trim or eviction; 0 forever without a cache)."""
        return self._prefix.epoch if self._prefix is not None else 0

    def peek_prefix(self, prompt: "list[int]") -> int:
        """Usable resident-prefix length for ``prompt`` now (0 on a miss
        or without a cache), moving no counter or recency."""
        if self._prefix is None:
            return 0
        return self._prefix.peek(prompt, min_use=self.block_size)

    def request_class_stats(self) -> dict:
        """Live occupancy by priority class, the ``/debug/requests``
        provider's document: for each class with work in flight, its
        requests queued, decoding in a row, and swapped out to host."""
        classes: "dict[int, dict]" = {}
        for r in list(self._queue):
            row = classes.setdefault(r.priority, {"queued": 0, "decoding": 0, "swapped": 0})
            row["swapped" if r.swapped else "queued"] += 1
        for r in list(self._row_req):
            if r is not None:
                row = classes.setdefault(r.priority, {"queued": 0, "decoding": 0, "swapped": 0})
                row["decoding"] += 1
        return {"engine": self.name,
                "classes": {str(c): v for c, v in sorted(classes.items())}}

    def kv_snapshot(self) -> "dict | None":
        """The ``/debug/kv`` provider's document: `kv_block_stats`, the
        free-run lengths, and one record per allocated block with the
        owner tags resolved from this engine (``req:<id>`` table cells,
        ``entry:<len>t`` resident prefix entries; a shared block lists
        each).  None on rows.  A host-side walk of the pool, read by the
        scrape thread without stopping the engine."""
        if self._kv_layout != "paged":
            return None
        owners: "dict[int, list[str]]" = {}
        for row, req in enumerate(self._row_req):
            if req is None:
                continue
            for b in self._table[row]:
                if b:
                    owners.setdefault(int(b), []).append(f"req:{req.id}")
        if self._prefix is not None:
            for entry in self._prefix.export_blocks():
                for b in entry["blocks"]:
                    owners.setdefault(b, []).append(f"entry:{entry['length']}t")
        snap = self.kv_block_stats
        snap.update({
            "engine": self.name,
            "layout": "paged",
            "block_size": self.block_size,
            "table_cols": self._table_cols,
            "device_steps": self._device_steps,
            "free_runs": self._balloc.free_runs(),
            "blocks": self._balloc.block_records(owners=owners,
                                                 current_step=self._device_steps),
        })
        return snap

    def capacity_snapshot(self) -> dict:
        """The ``/debug/capacity`` provider's document: the cumulative
        occupancy-weighted busy and idle seconds (their sum is the ticks'
        summed wall time), the tick count, and the age of the last tick
        that held work (None: never)."""
        last = self._cap_last_step_mono
        return {
            "engine": self.name,
            "slots": self.slots,
            "busy_s": self._cap_busy_s,
            "idle_s": self._cap_idle_s,
            "steps": self._cap_steps,
            "last_step_age_s": None if last is None else time.monotonic() - last,
        }

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a row (swapped-out and handed-in ones too)."""
        return len(self._queue)

    @property
    def occupancy(self) -> int:
        """Rows currently mid-decode."""
        return sum(r is not None for r in self._row_req)

    @property
    def pending(self) -> int:
        """Requests queued or mid-decode."""
        return len(self._queue) + self.occupancy

    @property
    def kv_layout(self) -> str:
        """The KV storage layout: ``"paged"`` (a block pool and per-request
        block tables) or ``"rows"`` (one full-context row a slot)."""
        return self._kv_layout

    @property
    def device_steps(self) -> int:
        """Decode steps run so far (each steps every row; a fused call
        counts all of its steps)."""
        return self._device_steps

    @property
    def wasted_steps(self) -> int:
        """Row-steps spent on requests that had finished earlier in the
        same fused call (their tokens dropped): 0 under continuous
        scheduling."""
        return self._wasted_steps

    @property
    def kv_block_stats(self) -> "dict[str, int]":
        """The allocator's live counts (blocks_total/free/allocated/
        aliased), the cumulative admission counters (blocks aliased,
        COW-copied, freshly allocated), the host tier (blocks parked now,
        capacity, swap traffic, preemptions) and the handoff traffic.
        Empty on rows, which has no blocks."""
        if self._kv_layout != "paged":
            return {}
        stats = self._balloc.stats()
        stats["alias_blocks_total"] = self._kv_counts["alias_blocks"]
        stats["cow_blocks_total"] = self._kv_counts["cow_blocks"]
        stats["alloc_blocks_total"] = self._kv_counts["alloc_blocks"]
        stats["blocks_host"] = self._host_pool.used_count
        stats["host_capacity"] = self._host_pool.capacity
        stats["swap_out_blocks_total"] = self._swap_counts["out_blocks"]
        stats["swap_in_blocks_total"] = self._swap_counts["in_blocks"]
        stats["preemptions_total"] = self._swap_counts["preemptions"]
        stats["handoff_out_blocks_total"] = self._handoff_counts["out_blocks"]
        stats["handoff_in_blocks_total"] = self._handoff_counts["in_blocks"]
        stats["handoffs_alias_total"] = self._handoff_counts["alias"]
        stats["handoffs_dma_total"] = self._handoff_counts["dma"]
        return stats

    def moe_assignments(self) -> "list[list[int]] | None":
        """The assignments each expert of each expert layer took since
        the engine was built (every decode row, and the prefill windows'
        real prompt tokens), as (layer, expert) lists; None for a model
        without top-k experts.  A host sync: the tally lives on the
        device and the engine never reads it in a tick.  Each call adds
        what moved since the last one to
        ``tpu_dra_serve_moe_assignments_total{expert}`` (summed over the
        layers)."""
        tally = self._model.tally
        if tally is None:
            return None
        now = tally.tolist()
        seen = self._moe_seen or [[0] * len(r) for r in now]
        for e in range(len(now[0]) if now else 0):
            moved = sum(r[e] for r in now) - sum(r[e] for r in seen)
            if moved:
                SERVE_MOE_ASSIGNMENTS.inc(moved, expert=str(e))
        self._moe_seen = now
        return now

    @property
    def prefix_stats(self) -> "dict[str, int]":
        """The prefix cache's counters (hits, misses, evictions,
        resident, pool_slots, epoch, trimmed_blocks; zeros without a
        cache), the admission prefill split: tokens computed, and
        tokens reused (aliased instead of prefilled), the paged
        prefill's windows by path: replayed from captured CUDA graphs
        (``prefill_windows_graph``) or launched op by op
        (``prefill_windows_eager``; zeros on rows), and the decode steps
        by path (``decode_steps_graph``, ``decode_steps_eager``; every
        rows step is eager)."""
        stats = (
            self._prefix.stats()
            if self._prefix is not None
            else {"hits": 0, "misses": 0, "evictions": 0, "resident": 0, "pool_slots": 0,
                  "epoch": 0}
        )
        stats["prefill_tokens_computed"] = self._prefill_tokens["computed"]
        stats["prefill_tokens_reused"] = self._prefill_tokens["reused"]
        stats["prefill_windows_graph"] = self._prefill_windows["graph"]
        stats["prefill_windows_eager"] = self._prefill_windows["eager"]
        stats["decode_steps_graph"] = self._decode_steps["graph"]
        stats["decode_steps_eager"] = self._decode_steps["eager"]
        return stats

    def close(self) -> None:
        """Mark the engine closed, stop a running profile, retire its
        gauge series and obs providers, and drop its references to the
        device KV (an engine sharing the pool keeps its own); later
        `submit` and `tick` raise.  Idempotent; finished requests, the
        prefix index and the snapshots stay readable."""
        self._closed = True
        if self._profiler is not None:
            self._stop_profile()
        self._profile_left = 0
        SERVE_QUEUE_DEPTH.remove_function(engine=self.name)
        SERVE_BATCH_OCCUPANCY.remove_function(engine=self.name)
        SERVE_TIER_ENGINES.remove_function(engine=self.name, tier=self.tier)
        if self._kv_layout == "paged":
            for state in _KV_STATES:
                SERVE_KV_BLOCKS.remove(engine=self.name, state=state)
            obskv.unregister(self.name)
        obsreq.unregister(self.name)
        obscap.unregister(self.name)
        if self._kv_layout == "paged":
            self._pool = None
            self._prefill_graphs = self._step_graphs = None
        else:
            self._cache = None
            if self._prefix is not None:
                self._prefix.pool = None

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                f"ServeEngine {self.name!r} is closed: no further submissions or ticks "
                "(restart with a fresh engine; warm_start() rebuilds the prefix cache)"
            )
