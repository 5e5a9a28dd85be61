"""Paged KV pool: block-granular KV with per-request block tables.

Counterpart of `tpu_dra.parallel.paged`, on one device or on a mesh of
ranks (below).  One allocation
of ``num_blocks`` fixed-size blocks (``{"k","v"}`` of ``(L, NB, W, H,
d_head)`` bf16, or int8 ``{"q","s"}`` pairs with one f32 scale per token
and head) is addressed through ``(B, NW)`` int32 block tables, so a
request holds only the blocks its own context needs.  Block 0 is
scratch: never allocated, permanently referenced; freed table rows point
at it, so frozen rows' writes land there and unallocated columns read
masked garbage instead of faulting.  Writes go into the pool IN PLACE
(``index_put_``) where the reference returned a new pool.

The attention read has two backends behind the `decode` kv_io seam:
``"gather"`` (`_PagedKV`) gathers the table's reach and runs the dense
masked attention; ``"cuda"`` (`_PagedKernelKV`) hands the contraction to
`kernels.paged_attention`, which walks the pool block by block.

Whole blocks move through three plain indexing primitives (the
reference's are single-block ``dynamic_slice`` updates, not kernels):
`read_block` (a COPY of one block, every layer — the swap-out and dma
handoff payload), `write_block` (its inverse) and `copy_block` (the COW
privatization).  The rule they serve: a block with more than one owner
is never written.

On one CUDA device the engine replays its admission windows and its
decode step from CUDA graphs captured when it is built: the model hands
it both as parts (`PagedLM.prefill_parts`, `PagedLM.decode_parts`), and
`PartGraphs` captures and replays them.

On a mesh (``mesh=`` on `init_block_pool`, `paged_decode_step_rows` and
`make_paged_prefill`; `block_pool_spec`) a rank holds its heads of every
block: the pool is shared storage addressed by the tables, so it is
whole over ``data`` x ``fsdp``.  A step's rows are computed where
`decode` puts them (over data x fsdp when the batch divides it), so
before the scatter the new K and V of every rank's rows are all-gathered
over data x fsdp and every rank writes all of them: the pool's replicas
stay equal.  Reads gather the rank's own rows' reach.  The three block
primitives move the rank's heads of a block.  The CUDA kernel serves one
device only, as the reference's Pallas kernel does; a mesh reads KV by
the gather.
"""

from __future__ import annotations

import time

import torch

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.burnin import BurninConfig, _logits, _mlp
from tpu_dra_torch.parallel.decode import (
    ATTN_RANGE,
    _attn_half,
    _check_chunk,
    _check_prefix_window,
    _embed_lookup,
    _embed_mesh,
    _kv_writes,
    _layer,
    _local_heads,
    _place,
    _rope_tab,
    _rows,
    _Rows,
    _run_blocks,
    _run_blocks_mesh,
    _values,
    _zeros_kv,
)
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.kernels import paged_attn
from tpu_dra_torch.parallel.moe import expert_capacity
from tpu_dra_torch.parallel.quant import dequantize_bf16, is_quantized_leaf
from tpu_dra_torch.parallel.weights import cast_matrices
from tpu_dra_torch.utils import trace
from tpu_dra_torch.utils.metrics import SERVE_KV_BLOCK_AGE_SECONDS

__all__ = [
    "BlockAllocator",
    "PagedLM",
    "PartGraphs",
    "block_pool_spec",
    "copy_block",
    "init_block_pool",
    "make_paged_prefill",
    "paged_decode_step_rows",
    "read_block",
    "run_parts",
    "write_block",
]


def block_pool_spec(config: BurninConfig, kv_int8: bool = False):
    """The pool's layout on a mesh (the port's spec: an entry a dim):
    heads over ``model``, everything else whole (blocks are shared
    storage; the batch lives in the tables, not in the pool); with
    ``kv_int8`` the ``{"q","s"}`` pair of it."""
    spec = (None, None, None, "model", None)
    return {"q": spec, "s": spec} if kv_int8 else spec


def init_block_pool(config: BurninConfig, num_blocks: int, block_size: int,
                    kv_int8: bool = False, device: "str | torch.device" = "cuda", mesh=None):
    """Zeroed block pool: ``{"k","v"}`` of ``(L, NB, W, H, d_head)`` bf16,
    or with ``kv_int8`` the pair ``{"q": int8 (L, NB, W, H, d_head), "s":
    f32 (L, NB, W, H, 1)}`` each (`decode.init_cache`'s storage).  Zeros,
    not uninitialized memory: scratch block 0 is read (masked) by frozen
    rows, and masked garbage must still be finite.  On a ``mesh`` the
    rank's heads (H / model) on the rank's device (``device`` not read)."""
    c = config
    if num_blocks < 2:
        raise ValueError(
            f"block pool needs >= 2 blocks (block 0 is scratch), got {num_blocks}"
        )
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if mesh is None:
        dev, heads = resolve_device(device), c.n_heads
    else:
        place = spmd.Place(mesh)
        dev, heads = place.device, _local_heads(c, place)
    shape = (c.n_layers, num_blocks, block_size, heads, c.d_head)
    return {name: _zeros_kv(shape, kv_int8, dev) for name in ("k", "v")}


class _PagedKV:
    """`decode._run_blocks` kv_io adapter: reads gather the whole table
    reach ``(B, NW*W, H, K)``; writes scatter in place into
    table-addressed blocks — one token per row (decode, per-row
    positions) or one full W-token block (a prefill window).  Rows must
    target distinct blocks; the shared scratch block takes racing writes
    by design and is never read unmasked."""

    def __init__(self, table, block_size: int):
        self.table = table  # (B, NW) int32
        self.W = block_size

    def read(self, cbuf):
        """The table's reach as bf16 (B, NW*W, H, K): an int8 pool's
        values and scales gathered, then dequantized."""
        def gather(buf):
            g = buf[self.table.long()]  # (B, NW, W, H, K')
            return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])

        if is_quantized_leaf(cbuf):
            return dequantize_bf16({"q": gather(cbuf["q"]), "s": gather(cbuf["s"])})
        return gather(cbuf)

    def write(self, cbuf, new, p0):
        """``new`` into the table's blocks, in place; an int8 pool gets it
        quantized (values and scales) once, here."""
        per_row = torch.is_tensor(p0) and p0.dim() >= 1
        if per_row:
            if new.shape[1] != 1:
                raise ValueError(
                    f"per-row paged writes are single-token (S=1), got S={new.shape[1]}"
                )
            p0 = p0.long()
            rows = torch.arange(new.shape[0], device=new.device)
            blk = self.table[rows, p0 // self.W].long()  # (B,)
        else:
            if new.shape[1] != self.W:
                raise ValueError(
                    f"scalar-p0 paged writes fill one block (S=W={self.W}), "
                    f"got S={new.shape[1]}"
                )
            # A scalar p0 is a window start on the W grid: the write fills
            # block column p0 // W of every row.
            blk = self.table[:, p0 // self.W].long()
        for buf, upd in _kv_writes(cbuf, new):
            if per_row:
                buf.index_put_((blk, p0 % self.W), upd[:, 0])
            else:
                buf.index_put_((blk,), upd)
        return cbuf


class _PagedKernelKV(_PagedKV):
    """The kernel backend: writes scatter exactly like `_PagedKV`, but
    there is no read — ``attend`` hands the whole contraction, and the
    layer's pool leaves as they are stored (bf16, or int8 ``{"q","s"}``
    pairs), to `kernels.paged_attention` (decode steps only: one query
    per row at its own position, the mask the dense path would build
    from ``pos``)."""

    def __init__(self, table, block_size: int, pos):
        super().__init__(table, block_size)
        self.pos = pos  # (B,) int32 per-row query positions

    def attend(self, q, ck, cv):
        from tpu_dra_torch.parallel.kernels import paged_attention

        if q.shape[1] != 1:
            raise ValueError(
                f"paged attention is the decode-step kernel (S=1 queries), got S={q.shape[1]}"
            )
        out = paged_attention(q[:, 0].contiguous(), ck, cv, self.table, self.pos)
        return out[:, None]


class _MeshPagedKV(_PagedKV):
    """`_PagedKV` on a mesh: reads gather the reach of the rank's own
    rows' table rows; a write gathers the new K/V of every rank's rows
    (over ``fsdp``, then ``data``) and scatters all of them through the
    whole ``table`` (at the global ``pos`` of a decode step), so every
    replica of the pool over data x fsdp takes the same writes."""

    def __init__(self, table, block_size: int, rows: _Rows, pos=None):
        super().__init__(rows.own(table), block_size)
        self.all = _PagedKV(table, block_size)
        self.rows, self.pos = rows, pos

    def write(self, cbuf, new, p0):
        per_row = torch.is_tensor(p0) and p0.dim() >= 1
        new = self.rows.to_global(self.rows.to_group(new))
        return self.all.write(cbuf, new, self.pos if per_row else p0)


# The reference engine's refusal of its kernel on a mesh (serve.py:534-540).
MESH_KERNEL_REFUSAL = (
    "attn_backend='cuda' serves single-device engines only for now: the "
    "sharded engine stays on the gather path until a sharded kernel lands "
    "(pass attn_backend='gather' or 'auto')"
)


def paged_decode_step_rows(params, tok, pool, table, pos, config: BurninConfig,
                           backend: str = "gather", mesh=None):
    """One decode step with PER-ROW positions through block tables: row
    ``b``'s token lands in block ``table[b, pos[b] // W]`` at offset
    ``pos[b] % W`` (in place) and attends ``j <= pos[b]``.  Returns
    ``(logits (B, vocab), pool)``.

    ``backend``: ``"gather"`` gathers the table's reach for the dense
    masked attention; ``"cuda"`` routes the contraction through
    `kernels.paged_attention` (the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors).  ``table``/``pos`` are int32.

    A row at or past its reach (the table's last slot or the context's,
    whichever comes first) is an overrun row, which only a fused tick
    makes: its request has finished and its output is dropped.  It runs
    at the reach's last position over a table row of scratch, so every
    gather and the kernel's walk stay in range and its writes land in
    scratch block 0 alone.

    On a ``mesh``: ``tok``, ``table`` and ``pos`` are the global rows,
    ``pool`` the rank's heads, the logits the rank's rows; the backend is
    the gather."""
    if backend not in ("gather", "cuda"):
        raise ValueError(f"backend must be 'gather' or 'cuda', got {backend!r}")
    if mesh is None:
        return _paged_step(params, tok, pool, table, pos, config, backend)
    if backend == "cuda":
        raise ValueError(MESH_KERNEL_REFUSAL)
    rows = _Rows(spmd.Place(mesh), tok.shape[0])
    logits, pool = _paged_step(params, tok, pool, table, pos, config, backend, rows)
    return rows.own_of_group(logits), pool


def _paged_step(params, tok, pool, table, pos, config: BurninConfig, backend: str,
                rows: "_Rows | None" = None):
    """`paged_decode_step_rows`' body: on one device its parts
    (`_decode_parts`) in order; on a mesh (``rows``) the logits of the
    rank's fsdp group's rows."""
    if rows is None:
        st = {"tok": tok, "table": table, "pos": pos}
        return run_parts(_decode_parts(params, pool, config, backend), st)["logits"], pool
    W = _pool_block_size(pool)
    table, pos = _clamp_to_reach(table, pos, W, config.seq)
    own = rows.own(pos)
    pos_emb = None if config.rope else params["pos"][own][:, None, :]
    x = _embed_mesh(params, tok[:, None], pos_emb, rows)
    slots = torch.arange(table.shape[1] * W, device=tok.device)[None, :]
    mask = (slots <= own[:, None])[:, None, None, :]
    kv_io = _MeshPagedKV(table, W, rows, pos)
    logits, pool = _run_blocks_mesh(params, x, pool, own, mask, config, rows, kv_io=kv_io)
    return logits[:, 0], pool


def _clamp_to_reach(table, pos, W: int, seq: int):
    """``(table, pos)`` with every overrun row (at or past the reach)
    moved to the reach's last position over a table row of scratch."""
    reach = min(table.shape[1] * W, seq)
    over = pos >= reach
    return torch.where(over[:, None], 0, table), pos.clamp(max=reach - 1)


# The attention half's leaves of a layer; the MLP half reads the others.
_ATTN_LEAVES = ("ln1", "wqkv", "wo")


def _decode_parts(params, pool, config: BurninConfig, backend: str) -> list:
    """The one-device decode step cut at its block halves, in order:
    ``(name, part)`` pairs, each ``part(st)`` reading and writing the
    step's state ``st`` (the inputs ``tok``, ``table``, ``pos``; the
    residual stream ``x``; ``logits`` at the end).  The head clamps the
    overrun rows and embeds the tokens, then come every block's
    attention and MLP halves (an int8 layer's matrices dequantized in
    the half that reads them), and the tail's final norm and logits.
    ``name`` is the range a replay of the part's graph runs under
    (`PartGraphs`); eagerly the attention half opens it itself."""
    c = config
    W = _pool_block_size(pool)
    mlp_leaves = [n for n in params["layers"] if n not in _ATTN_LEAVES]
    capacity = min(1, expert_capacity(c)) if c.moe_experts > 0 else None

    def leaves(i, names):
        return {n: dequantize_bf16(_layer(params["layers"][n], i)) for n in names}

    def head(st):
        table, pos = _clamp_to_reach(st["table"], st["pos"], W, c.seq)
        x = _embed_lookup(params["embed"], st["tok"])[:, None, :]
        if not c.rope:
            x = x + params["pos"][pos][:, None, :]
        slots = torch.arange(table.shape[1] * W, device=pos.device)[None, :]
        st["mask"] = (slots <= pos[:, None])[:, None, None, :]  # (B, 1, 1, NW*W)
        st["rope"] = _rope_tab(c, pos, x)
        st["kv"] = _PagedKernelKV(table, W, pos) if backend == "cuda" else _PagedKV(table, W)
        st["pos_c"], st["x"] = pos, x

    def attn(i):
        def part(st):
            st["x"], _, _ = _attn_half(leaves(i, _ATTN_LEAVES), st["x"], _layer(pool["k"], i),
                                       _layer(pool["v"], i), st["pos_c"], c, st["mask"],
                                       st["rope"], st["kv"])
        return part

    def mlp(i):
        def part(st):
            st["x"], _ = _mlp(leaves(i, mlp_leaves), st["x"], c, capacity)
        return part

    def tail(st):
        st["logits"] = _logits(params, st["x"])[:, 0]

    parts = [(None, head)]
    for i in range(c.n_layers):
        parts += [(ATTN_RANGE, attn(i)), (None, mlp(i))]
    return parts + [(None, tail)]


def _pool_block_size(pool) -> int:
    """Block width W of a pool in either storage format."""
    return _values(pool["k"]).shape[2]


def make_paged_prefill(config: BurninConfig, prompt_slots: int, window: int, mesh=None):
    """Block-table prefill: returns ``prefill(params, prompt, lens_c,
    pool, table, first_window=0) -> (last, pool)``, which runs the padded
    prompt's W-token windows ``[first_window, prompt_slots/W)`` in order,
    each writing its KV into block ``table[:, i]`` (in place) and
    attending over the table-gathered pool.  ``last`` (B, vocab) holds
    each row's logits at its own last real position ``lens_c[b] - 1``.
    Windows of trailing pads write garbage into the row's own decode
    blocks (overwritten by decode before the mask reaches them) or into
    scratch.  On a ``mesh`` the prompt, lengths and table are global, the
    pool the rank's heads, ``last`` the rank's rows (a B=1 admission is
    replicated over data x fsdp: every rank prefills it).  On one CUDA
    device the engine replays the same windows as captured CUDA graphs
    (`PagedLM.prefill_parts`)."""
    c = config
    _check_prefix_window(c, prompt_slots, window)
    W = window
    nwin = prompt_slots // W
    place = _place(mesh)

    def prefill(params, prompt, lens_c, pool, table, first_window=0):
        if not 0 <= first_window < nwin:
            raise ValueError(f"first_window must be in [0, {nwin}), got {first_window}")
        rows = _rows(place, prompt.shape[0])
        if rows is None:
            kv = _PagedKV(table, W)
        else:
            kv = _MeshPagedKV(table, W, rows)
            lens_c = rows.group(lens_c)
        lens_c = lens_c.long()
        last = torch.zeros((lens_c.shape[0], c.vocab), device=prompt.device)
        for i in range(first_window, nwin):
            last, pool = _prefill_window(params, prompt, lens_c, pool, kv, last, i * W, c, rows)
        return (last if rows is None else rows.own_of_group(last)), pool

    return prefill


def _prefill_window(params, prompt, lens_c, pool, kv: _PagedKV, last, p0: int,
                    c: BurninConfig, rows: "_Rows | None" = None):
    """The prefill's window at ``p0`` (on the W grid): its tokens' KV
    into block column ``p0 // W`` of ``kv``'s table, attending over the
    table's reach; ``last`` takes the logits of each row whose last real
    position ``lens_c - 1`` falls in the window.  Returns ``(last,
    pool)``."""
    W, dev = kv.W, prompt.device
    t_eff = kv.table.shape[1] * W
    valid = (
        torch.arange(t_eff, device=dev)[None, :]
        <= p0 + torch.arange(W, device=dev)[:, None]
    )  # (W, NW*W)
    if rows is not None:
        pos_emb = None if c.rope else params["pos"][None, p0:p0 + W, :]
        x = _embed_mesh(params, prompt[:, p0:p0 + W], pos_emb, rows)
        logits, pool = _run_blocks_mesh(params, x, pool, p0, valid[None, None], c, rows,
                                        kv_io=kv)
    else:
        x = _embed_lookup(params["embed"], prompt[:, p0:p0 + W])
        if not c.rope:
            x = x + params["pos"][None, p0:p0 + W, :]
        logits, pool = _run_blocks(params, x, pool, p0, valid[None, None], c, kv_io=kv)
    n = lens_c.shape[0]
    off = lens_c.long() - 1 - p0  # last real position, window-relative
    cand = logits[torch.arange(n, device=dev), off.clamp(0, W - 1)]
    hit = (off >= 0) & (off < W)
    return torch.where(hit[:, None], cand, last), pool


def run_parts(parts: list, st: dict, first: int = 0) -> dict:
    """Run ``(name, part)`` pairs ``[first, n)`` op by op over ``st``
    (each ``part(st)`` reads and writes it); returns ``st``."""
    for _, part in parts[first:]:
        part(st)
    return st


class PartGraphs:
    """``(name, part)`` pairs (`run_parts`' parts: a model's prefill
    windows or decode step) captured once each as a CUDA graph on one
    CUDA device, and replayed: the eager parts' kernels in the same order
    on the caller's stream, one launch a part where the eager run issues
    every product, norm, gather and kernel.  A named part replays under
    that profiler range (the one its eager form opens), so a profile
    still splits the computation.  The tensors in ``st`` are the static
    inputs, and the parts leave their outputs there; the graphs address
    what the parts closed over (params, pool) as it was at capture.

    Capture runs on the constructing thread (``thread_local`` error mode,
    so other threads' CUDA work does not void it) on a side stream, after
    one warm-up pass of every part there, op by op, over a copy of
    ``st``.  The parts share one private memory pool and replay in
    capture order on one stream, so what one part leaves is what the
    next reads, and no two replays' intermediates overlap in time."""

    def __init__(self, parts: list, st: dict):
        dev = next(t.device for t in st.values() if torch.is_tensor(t))
        self.st = st
        self._graphs: "list[tuple[str | None, torch.cuda.CUDAGraph]]" = []
        with torch.cuda.device(dev):
            caller, stream = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                run_parts(parts, dict(st))
            mempool = torch.cuda.graph_pool_handle()
            for name, part in parts:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=mempool, stream=stream,
                                      capture_error_mode="thread_local"):
                    part(st)
                self._graphs.append((name, graph))
            # The warm-up's writes (scratch, the static outputs) before
            # the caller's next work.
            caller.wait_stream(stream)

    def replay(self, first: int = 0, **inputs) -> dict:
        """Replay parts ``[first, n)`` in order, each of ``inputs`` first
        copied into its static input unless it is that storage already.
        Returns ``st``, whose outputs stay valid until the next replay."""
        if not 0 <= first < len(self._graphs):
            raise ValueError(f"first must be in [0, {len(self._graphs)}), got {first}")
        st = self.st
        for name, t in inputs.items():
            if t.data_ptr() != st[name].data_ptr():
                st[name].copy_(t)
        for name, graph in self._graphs[first:]:
            if name is None:
                graph.replay()
            else:
                with trace.range(name):
                    graph.replay()
        return st


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of pool-shaped nested dicts (``{"k",
    "v"}`` of tensors or of int8 ``{"q","s"}`` pairs), keeping the nesting."""
    if isinstance(trees[0], dict):
        return {key: _tree_map(fn, *(t[key] for t in trees)) for key in trees[0]}
    return fn(*trees)


def read_block(pool, src: int):
    """A COPY of physical block ``src``, every layer, either storage
    format: leaves keep the blocks axis, ``(L, 1, W, H, K')``, so
    `write_block` takes the tree back verbatim.  A copy, not a view: the
    pool is written in place, and a payload parked in the host tier must
    not change when its block is reallocated and rewritten."""
    return _tree_map(lambda b: b[:, src:src + 1].clone(), pool)


def write_block(pool, dst: int, data):
    """Write a `read_block`-shaped tree into physical block ``dst``, in
    place (host payloads upload on the pool's stream); returns the pool.
    The round trip is bitwise, so a restored row decodes as if it had
    never left."""
    _tree_map(lambda b, d: b[:, dst:dst + 1].copy_(d, non_blocking=True), pool, data)
    return pool


def copy_block(pool, dst: int, src: int):
    """Copy physical block ``src`` into block ``dst`` (every layer, both
    formats), in place; returns the pool.  The COW primitive: the
    engine privatizes the partial last prompt block a parked entry
    shares with its live request, so shared blocks are never written."""
    _tree_map(lambda b: b[:, dst].copy_(b[:, src]), pool)
    return pool


class BlockAllocator:
    """Host-side free list + per-block refcounts over a block pool (the
    reference's allocator).

    Block 0 is the SCRATCH block: never handed out, permanently
    referenced.  ``alloc`` hands out blocks at refcount 1 (the caller's
    table cell); ``ref`` adds an owner (a prefix entry aliasing the
    block, or a second table cell); ``unref`` drops one and returns the
    block to the free list at zero.  The free list is LIFO with low ids
    first out.

    Every allocated block carries a host record, kept only on the
    alloc/ref/unref paths (admission and finish, never per token): birth
    time on the monotonic clock, birth and last-touch step (the caller's
    device-step counter), and origin (``computed``, ``cow``, ``swapin``,
    ``handoff``).  The block-granular LRU
    (`prefixcache.PagedPrefixCache.evict_one`) and the swap victim policy
    (`swap.AgeHeatPolicy`) rank coldness by them.  ``clock`` gives the
    birth times and ages (default ``time.monotonic``, seconds; a mesh
    engine's ranks each run this allocator, and pass a clock they all
    read alike, so that their victim picks agree).  Freeing a block
    observes its residency on the monotonic clock into
    ``tpu_dra_serve_kv_block_age_seconds{engine=name}``; that series only
    records, it decides nothing, so a mesh engine's ages stay counted in
    device steps for every decision."""

    def __init__(self, num_blocks: int, clock=None, name: str = ""):
        if num_blocks < 2:
            raise ValueError(
                f"allocator needs >= 2 blocks (block 0 is scratch), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self._clock = clock
        # The owning engine's name: the label of the block-age series
        # (the engine assigns it once it knows its own).
        self.name = name
        self._ref = [0] * num_blocks
        self._ref[0] = 1  # scratch: immortal, never in the free list
        self._free = list(range(num_blocks - 1, 0, -1))
        # Per-block records (row 0 unused), parallel lists written in place.
        self._birth_mono = [0.0] * num_blocks
        # The monotonic birth times the block-age series reads: the same
        # list when the clock is the monotonic one.
        self._birth_wall = self._birth_mono if clock is None else [0.0] * num_blocks
        self._birth_step = [0] * num_blocks
        self._touch_step = [0] * num_blocks
        self._origin = [""] * num_blocks

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        """Blocks owned by at least one table cell or entry (scratch
        excluded)."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def aliased_count(self) -> int:
        """Blocks with more than one owner."""
        return sum(1 for r in self._ref[1:] if r >= 2)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def last_touch_step(self, block: int) -> int:
        """Device step of the block's last alloc / ref / unref: the heat
        signal the LRU trim and the swap policy rank by."""
        return self._touch_step[block]

    def alloc(self, n: int, *, step: int = 0,
              origin: str = "computed") -> "list[int] | None":
        """``n`` fresh blocks at refcount 1, or None (and no allocation)
        when fewer than ``n`` are free; ``step``/``origin`` stamp the
        blocks' records."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        now = self._now()
        wall = now if self._clock is None else time.monotonic()
        for b in out:
            self._birth_mono[b] = now
            self._birth_wall[b] = wall
            self._birth_step[b] = step
            self._touch_step[b] = step
            self._origin[b] = origin
            self._ref[b] = 1
        return out

    def ref(self, blocks, *, step: "int | None" = None) -> None:
        for b in blocks:
            if b == 0 or self._ref[b] <= 0:
                raise RuntimeError(f"ref of unowned block {b} (scratch or free)")
        for b in blocks:
            self._ref[b] += 1
            if step is not None:
                self._touch_step[b] = step

    def unref(self, blocks, *, step: "int | None" = None) -> None:
        now = None
        for b in blocks:
            if b == 0 or self._ref[b] <= 0:
                raise RuntimeError(f"unref of unowned block {b} (scratch or free)")
            self._ref[b] -= 1
            if step is not None:
                self._touch_step[b] = step
            if self._ref[b] == 0:
                self._free.append(b)
                if now is None:
                    now = time.monotonic()
                SERVE_KV_BLOCK_AGE_SECONDS.observe(now - self._birth_wall[b], engine=self.name)
                self._origin[b] = ""

    def _now(self) -> float:
        return time.monotonic() if self._clock is None else self._clock()

    def free_runs(self) -> "list[int]":
        """Lengths of the contiguous free-block runs, in block-id order
        (scratch excluded)."""
        runs: "list[int]" = []
        run = 0
        for b in range(1, self.num_blocks):
            if self._ref[b] == 0:
                run += 1
            elif run:
                runs.append(run)
                run = 0
        if run:
            runs.append(run)
        return runs

    def block_records(self, owners: "dict[int, list[str]] | None" = None,
                      current_step: int = 0) -> "list[dict]":
        """One record per ALLOCATED block (scratch and free excluded):
        refcount, origin, birth/last-touch step, idle steps at
        ``current_step``, age on the allocator's clock, and the owner tags
        the caller resolved for it (``owners``: block -> tags)."""
        now = self._now()
        owners = owners or {}
        return [
            {
                "block": b,
                "refcount": self._ref[b],
                "origin": self._origin[b],
                "birth_step": self._birth_step[b],
                "last_touch_step": self._touch_step[b],
                "idle_steps": max(0, current_step - self._touch_step[b]),
                "age_s": round(max(0.0, now - self._birth_mono[b]), 6),
                "owners": list(owners.get(b, ())),
            }
            for b in range(1, self.num_blocks)
            if self._ref[b] > 0
        ]

    def stats(self) -> "dict[str, int]":
        return {
            "blocks_total": self.num_blocks,
            "blocks_free": self.free_count,
            "blocks_allocated": self.allocated_count,
            "blocks_aliased": self.aliased_count,
        }


class PagedLM:
    """The burn-in LM's side of `serve.ServeEngine`'s model seam
    (`BurninConfig.paged_model`): the engine asks its model for the
    served tree, the pool, the eager prefill and decode step, and the
    parts of both that it captures as CUDA graphs on one CUDA device
    (`PartGraphs`), through these methods, has it check the engine's
    options, and tells it of admissions, captures and finished requests.
    ``kernel`` is the decode kernel whose launch counter a step on
    ``attn_backend="cuda"`` feeds (K1).  Here each is this module's own
    function; `models.mla_moe.PagedMlaMoe` is the latent-attention
    model's."""

    tally = None  # no expert tally: the switch layer serves on rows
    swap_tier = True
    kernel = paged_attn

    def __init__(self, config: BurninConfig, *, record_routes: bool = False):
        if record_routes:
            raise ValueError("record_routes keeps a top-k router's choices: the burn-in LM "
                             "has none")
        self.config = config

    @property
    def default_layout(self) -> str:
        """MoE serves on rows: the paged prefill runs in windows, and
        per-window capacity queues would route other tokens than the
        one-shot prefill."""
        return "rows" if self.config.moe_experts > 0 else "paged"

    def refuse(self, *, kv_layout, **_engine_options) -> None:
        if kv_layout == "paged" and self.config.moe_experts > 0:
            raise ValueError(
                "kv_layout='paged' is not supported with moe_experts > 0: "
                "the block-table prefill runs in windows, which would "
                "restart the per-expert capacity queues and diverge from "
                "the one-shot routing (serve MoE with kv_layout='rows')"
            )

    def check_chunk(self, prompt_slots: int, prefill_chunk: "int | None") -> None:
        _check_chunk(self.config, prompt_slots, prefill_chunk, "prompt_slots")

    def check_window(self, prompt_slots: int, window: int) -> None:
        _check_prefix_window(self.config, prompt_slots, window)

    def prepare(self, params):
        return cast_matrices(params)

    def init_pool(self, num_blocks: int, block_size: int, *, kv_int8: bool, device, mesh):
        return init_block_pool(self.config, num_blocks, block_size, kv_int8, device=device,
                               mesh=mesh)

    def make_prefill(self, prompt_slots: int, block_size: int, mesh=None):
        return make_paged_prefill(self.config, prompt_slots, block_size, mesh=mesh)

    def prefill_parts(self, params, pool, st: dict) -> list:
        """The B=1 admission prefill's windows as parts, in order: window
        ``i`` reads ``st["prompt"]`` (1, prompt_slots), ``st["lens"]``
        (1,) and ``st["table"]`` (1, cols) and updates ``st["last"]`` (1,
        vocab) in place (`make_paged_prefill`'s windows over one row)."""
        c = self.config
        kv = _PagedKV(st["table"], _pool_block_size(pool))

        def window(p0: int):
            def part(st):
                st["last"].copy_(_prefill_window(params, st["prompt"], st["lens"], pool, kv,
                                                 st["last"], p0, c)[0])
            return part

        return [(None, window(i * kv.W)) for i in range(st["prompt"].shape[1] // kv.W)]

    def decode_parts(self, params, pool, backend: str) -> list:
        """The one-device decode step as parts (`_decode_parts`)."""
        return _decode_parts(params, pool, self.config, backend)

    def captured(self) -> None:
        """The engine captured the parts: their warm-up wrote scratch alone."""

    def admitted(self, row: int, length: int) -> None:
        pass

    def finished(self, row: int, req) -> None:
        pass

    def fed_routes(self, row: int, req) -> None:
        return None

    def decode(self, params, tok, pool, table, pos, backend: str, rows: "_Rows | None" = None):
        """One decode step op by op (`_paged_step`): on one device the
        logits of every row, on a mesh (``rows``) of the rank's fsdp
        group's rows."""
        return _paged_step(params, tok, pool, table, pos, self.config, backend, rows)
