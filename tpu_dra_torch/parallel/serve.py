"""Continuous-batching serving engine over the paged decode step.

Counterpart of the core of `tpu_dra.parallel.serve.ServeEngine`: the
paged KV layout, greedy decoding, continuous scheduling.  Every batch
ROW has its own lifecycle —

    submit -> queue -> admit into a free row (paged prefill of the
    prompt into freshly allocated blocks) -> per-row decode steps ->
    finish (eos / budget) -> row and blocks freed -> next request admitted

— while the device runs one fixed-batch decode step for all rows.  Rows
without a request keep stepping with a frozen position (there is no
ragged batch): their table rows point at scratch block 0, so their
writes land there and nowhere else.

Admission is FIFO with the block-demand gate: the queue head is admitted
only when its worst-case block count (prompt plus budget) is free, so a
full pool delays admission instead of corrupting it.  There is exactly
ONE blocking device-to-host fetch per decode step and one per admission
wave (all of a wave's first tokens come back together).  The host state
the device needs (tokens, positions, the active mask, the block tables)
goes up through a pinned staging buffer, without a host sync.

Not ported yet: telemetry and the obs registrations, the prefix cache,
the host swap tier and preemption, disaggregated handoff, sampling and
logprobs, priorities, stop sequences, fused ticks and the rows layout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_dra_torch.parallel.burnin import BurninConfig
from tpu_dra_torch.parallel.decode import (
    _check_prefix_window,
    _check_window,
    _make_pick,
)
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.paged import (
    BlockAllocator,
    init_block_pool,
    make_paged_prefill,
    paged_decode_step_rows,
)
from tpu_dra_torch.parallel.quant import is_quantized
from tpu_dra_torch.parallel.weights import cast_matrices

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    """One submitted generation request and its accumulated output."""

    id: int
    prompt: "list[int]"
    max_new: int
    tokens: "list[int]" = field(default_factory=list)  # generated only
    done: bool = False
    finish_reason: str = ""  # "eos" | "budget"
    submitted_at: float = 0.0  # host perf_counter
    ttft_s: float = 0.0  # submit -> first token, queueing included


class ServeEngine:
    """Fixed-slot continuous-batching engine on a paged block pool.

    ``slots``: concurrent rows (the decode batch).  ``prompt_slots``:
    admission pad width; longer prompts are rejected at submit.
    ``max_new_cap``: the largest budget a request may ask for.
    ``eos_token``: generation stops early when the model emits it (None:
    budget only).  ``steps_per_tick``: decode steps each `tick` runs,
    each its own device call, with join/leave between them.

    ``attn_backend``: how a decode step reads KV — ``"cuda"`` runs the
    paged-attention CUDA kernel, ``"gather"`` gathers the table's reach
    for the dense attention, ``"auto"`` (default) picks ``"cuda"`` on a
    CUDA engine and ``"gather"`` on a CPU one.  ``"cuda"`` on a CPU
    engine raises.  ``kv_blocks``: blocks in the pool, scratch included
    (default: every slot can hold a worst-case request, ``slots *
    ceil((prompt_slots + max_new_cap) / W) + 1``).  ``prefix_window``:
    the block size W, which must divide ``prompt_slots`` (default: the
    largest divisor of ``prompt_slots`` up to a quarter of it).
    ``kv_int8``: the pool stores int8 values with one f32 scale per
    token and head (each written row quantized once, at insert).

    ``device``: where the pool and the computation live (default
    ``"cuda"``; raises when CUDA is absent).  ``params`` must be on it,
    plain or int8 (`quant.quantize_params`); the engine serves from a
    copy whose plain layer matrices are bf16, int8 pairs as they are."""

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
        attn_backend: str = "auto",
        kv_blocks: "int | None" = None,
        prefix_window: "int | None" = None,
        kv_int8: bool = False,
        device: "str | torch.device" = "cuda",
    ):
        c = config
        dev = resolve_device(device)
        # Every row must fit prompt + its budget in the context.
        _check_window(c, prompt_slots, max_new_cap, "prompt_slots")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if steps_per_tick < 1:
            raise ValueError(f"steps_per_tick must be >= 1, got {steps_per_tick}")
        if attn_backend not in ("auto", "gather", "cuda"):
            raise ValueError(
                f"attn_backend must be 'auto', 'gather' or 'cuda', got {attn_backend!r}"
            )
        if attn_backend == "auto":
            attn_backend = "cuda" if dev.type == "cuda" else "gather"
        if attn_backend == "cuda" and dev.type != "cuda":
            raise ValueError(
                "attn_backend='cuda' runs the CUDA kernel: it needs a CUDA "
                f"engine, this one is on {dev}"
            )
        embed = params["embed"]["q"] if is_quantized(params) else params["embed"]
        if embed.device.type != dev.type:
            raise ValueError(f"params are on {embed.device}, the engine on {dev}")
        if prefix_window is not None:
            w = prefix_window
        else:
            # ~ a quarter prompt, rounded down to a divisor: the
            # reference's default block size.
            cap = max(1, prompt_slots // 4)
            w = max(d for d in range(1, cap + 1) if prompt_slots % d == 0)
        _check_prefix_window(c, prompt_slots, w)

        self.config = c
        self.device = dev
        self.params = cast_matrices(params)
        self.slots = slots
        self.prompt_slots = prompt_slots
        self.max_new_cap = max_new_cap
        self.eos_token = eos_token
        self.steps_per_tick = steps_per_tick
        self.attn_backend = attn_backend
        self.block_size = w
        # Table width: enough columns for the longest legal request.
        # Shorter requests leave trailing columns at 0 (scratch).
        self._table_cols = -(-(prompt_slots + max_new_cap) // w)
        nb = kv_blocks if kv_blocks is not None else slots * self._table_cols + 1
        floor = self._table_cols + 1  # one worst-case request + scratch
        if nb < floor:
            raise ValueError(
                f"kv_blocks must be >= {floor} (one worst-case request + scratch), got {nb}"
            )
        self._balloc = BlockAllocator(nb)
        self._pool = init_block_pool(c, nb, w, kv_int8, device=dev)
        self._prefill = make_paged_prefill(c, prompt_slots, w)
        self._pick = _make_pick(False)
        # Host row state: the request, its position (== valid tokens in
        # the row), the token it feeds next, its block table.
        self._row_req: "list[Request | None]" = [None] * slots
        self._pos = [0] * slots
        self._tok = [0] * slots
        self._table = np.zeros((slots, self._table_cols), np.int32)
        # Pinned host staging (plain memory on a CPU engine), uploaded
        # without a host sync: one buffer for the per-step state — tok,
        # pos, active, then the tables — and one admission row per slot
        # (padded prompt, table row, length).  Each is rewritten only
        # after the fetch that ended the device work reading it.
        pin = dev.type == "cuda"
        self._stage = torch.zeros(
            3 * slots + slots * self._table_cols, dtype=torch.int32, pin_memory=pin
        )
        self._prompt_stage = torch.zeros(
            (slots, prompt_slots + self._table_cols + 1), dtype=torch.int32,
            pin_memory=pin,
        )
        self._queue: "list[Request]" = []
        self._done: "list[Request]" = []
        self._next_id = 0
        self._closed = False
        self._device_steps = 0

    # -- submission ------------------------------------------------------
    def submit(self, prompt: "list[int]", max_new: "int | None" = None) -> int:
        """Queue a request; returns its id.  Admission happens on `tick`.
        A bad prompt or budget raises here, never mid-tick."""
        self._check_open()
        for t in prompt:
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
        now = time.perf_counter()
        req = Request(id=self._next_id, prompt=list(prompt), max_new=budget, submitted_at=now)
        self._next_id += 1
        self._queue.append(req)
        return req.id

    # -- the engine loop -------------------------------------------------
    def _admit_paged(self, req: Request, row: int):
        """One paged admission: allocate the request's blocks, write its
        table row, prefill the prompt into them.  Returns the logits at
        the prompt's last position (1, vocab), left on the device."""
        w = self.block_size
        length = len(req.prompt)
        total_cols = -(-(length + req.max_new) // w)
        cols = self._balloc.alloc(total_cols)
        if cols is None:  # the admission gate holds this invariant
            raise RuntimeError(
                "paged admission accounting violated: demand was cleared "
                "but the allocator came up short"
            )
        self._table[row, :] = 0
        self._table[row, :total_cols] = cols
        # One upload: the padded prompt, the table row, the length.
        P = self.prompt_slots
        stage = self._prompt_stage[row].numpy()
        stage[:] = 0
        stage[:length] = req.prompt
        stage[P:P + self._table_cols] = self._table[row]
        stage[-1] = length
        staged = self._prompt_stage[row].to(self.device, non_blocking=True)
        last, self._pool = self._prefill(
            self.params, staged[None, :P], staged[-1:], self._pool,
            staged[None, P:P + self._table_cols],
        )
        return last

    def _admit(self) -> int:
        """Fill free rows from the FIFO queue; returns how many were
        admitted.  The head is admitted only when its worst-case block
        demand fits the free list; otherwise admission stops for this
        wave.  The wave's first tokens come back in ONE fetch."""
        wave: "list[tuple[int, Request, torch.Tensor]]" = []
        while self._queue and any(r is None for r in self._row_req):
            head = self._queue[0]
            need = -(-(len(head.prompt) + head.max_new) // self.block_size)
            if self._balloc.free_count < need:
                break
            row = self._row_req.index(None)
            req = self._queue.pop(0)
            last = self._admit_paged(req, row)
            self._row_req[row] = req
            self._pos[row] = len(req.prompt)
            wave.append((row, req, last[0]))
        if wave:
            toks = self._pick(torch.stack([last for _, _, last in wave])).tolist()
            for (row, _, _), tok in zip(wave, toks):
                self._tok[row] = tok
                self._note_token(row, tok)
        return len(wave)

    def _note_token(self, row: int, token: int) -> None:
        req = self._row_req[row]
        req.tokens.append(token)
        if len(req.tokens) == 1:
            req.ttft_s = time.perf_counter() - req.submitted_at
        if self.eos_token is not None and token == self.eos_token:
            req.done, req.finish_reason = True, "eos"
        elif len(req.tokens) >= req.max_new:
            req.done, req.finish_reason = True, "budget"
        if req.done:
            self._finish(row, req)

    def _finish(self, row: int, req: Request) -> None:
        """Release a finished request's row: drop its table's block
        references and point the row at scratch, so its frozen writes can
        never reach a block a later admission reallocates."""
        self._done.append(req)
        self._row_req[row] = None
        self._balloc.unref([int(b) for b in self._table[row] if b])
        self._table[row, :] = 0

    def _step_once(self) -> None:
        """One decode step for every row, its single blocking fetch, and
        the host-side token processing."""
        self._device_steps += 1
        B = self.slots
        active = [r is not None for r in self._row_req]
        stage = self._stage.numpy()
        stage[:B] = self._tok
        stage[B:2 * B] = self._pos
        stage[2 * B:3 * B] = active
        stage[3 * B:] = self._table.reshape(-1)
        state = self._stage.to(self.device, non_blocking=True)
        tok, pos = state[:B], state[B:2 * B]
        live = state[2 * B:3 * B].bool()
        table = state[3 * B:].view(B, self._table_cols)
        logits, self._pool = paged_decode_step_rows(
            self.params, tok, self._pool, table, pos, self.config,
            backend=self.attn_backend,
        )
        # Frozen rows keep their token and position, so their harmless
        # writes stay on one stale slot of scratch block 0.
        nxt = torch.where(live, self._pick(logits), tok)
        new_pos = torch.where(live, pos + 1, pos)
        # ONE blocking fetch per step: next tokens and positions together.
        toks, poss = torch.stack([nxt, new_pos]).tolist()
        self._tok = toks
        self._pos = poss
        for row in range(B):
            if self._row_req[row] is not None:
                self._note_token(row, toks[row])

    def tick(self) -> "list[Request]":
        """Admit waiting requests into free rows, then run
        ``steps_per_tick`` decode steps with join/leave between them.
        Returns the requests completed during this tick."""
        self._check_open()
        done_before = len(self._done)
        self._admit()
        for s in range(self.steps_per_tick):
            if s:
                self._admit()
            if all(r is None for r in self._row_req):
                break
            self._step_once()
        return self._done[done_before:]

    def run(self, until_idle: int = 10_000) -> "list[Request]":
        """Tick until queue and rows are empty; returns all completed
        requests in completion order.  ``until_idle`` bounds the loop."""
        for _ in range(until_idle):
            if self.idle:
                break
            self.tick()
        else:
            raise RuntimeError("engine did not drain within the tick bound")
        return self._done

    @property
    def idle(self) -> bool:
        """True when no request is queued or mid-decode."""
        return not self._queue and all(r is None for r in self._row_req)

    @property
    def queued(self) -> int:
        """Requests waiting for admission."""
        return len(self._queue)

    @property
    def device_steps(self) -> int:
        """Decode steps run so far (each steps every row)."""
        return self._device_steps

    def kv_stats(self) -> "dict[str, int]":
        """The block allocator's counts (`BlockAllocator.stats`)."""
        return self._balloc.stats()

    def close(self) -> None:
        """Mark the engine closed and drop its pool; later `submit` and
        `tick` raise.  Idempotent; finished requests stay readable."""
        self._closed = True
        self._pool = None

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("ServeEngine is closed: no further submissions or ticks")
