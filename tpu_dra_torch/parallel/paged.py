"""Paged KV pool: block-granular KV with per-request block tables.

Counterpart of `tpu_dra.parallel.paged` on one device.  One allocation
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
"""

from __future__ import annotations

import torch

from tpu_dra_torch.parallel.burnin import BurninConfig
from tpu_dra_torch.parallel.decode import (
    _check_prefix_window,
    _embed_lookup,
    _kv_writes,
    _run_blocks,
    _values,
    _zeros_kv,
)
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.quant import dequantize_bf16, is_quantized_leaf

__all__ = [
    "BlockAllocator",
    "init_block_pool",
    "make_paged_prefill",
    "paged_decode_step_rows",
]


def init_block_pool(config: BurninConfig, num_blocks: int, block_size: int,
                    kv_int8: bool = False, device: "str | torch.device" = "cuda"):
    """Zeroed block pool: ``{"k","v"}`` of ``(L, NB, W, H, d_head)`` bf16,
    or with ``kv_int8`` the pair ``{"q": int8 (L, NB, W, H, d_head), "s":
    f32 (L, NB, W, H, 1)}`` each (`decode.init_cache`'s storage).  Zeros,
    not uninitialized memory: scratch block 0 is read (masked) by frozen
    rows, and masked garbage must still be finite."""
    c = config
    if num_blocks < 2:
        raise ValueError(
            f"block pool needs >= 2 blocks (block 0 is scratch), got {num_blocks}"
        )
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    dev = resolve_device(device)
    shape = (c.n_layers, num_blocks, block_size, c.n_heads, c.d_head)
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


def paged_decode_step_rows(params, tok, pool, table, pos, config: BurninConfig,
                           backend: str = "gather"):
    """One decode step with PER-ROW positions through block tables: row
    ``b``'s token lands in block ``table[b, pos[b] // W]`` at offset
    ``pos[b] % W`` (in place) and attends ``j <= pos[b]``.  Returns
    ``(logits (B, vocab), pool)``.

    ``backend``: ``"gather"`` gathers the table's reach for the dense
    masked attention; ``"cuda"`` routes the contraction through
    `kernels.paged_attention` (the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors).  ``table``/``pos`` are int32."""
    if backend not in ("gather", "cuda"):
        raise ValueError(f"backend must be 'gather' or 'cuda', got {backend!r}")
    W = _pool_block_size(pool)
    x = _embed_lookup(params["embed"], tok)[:, None, :]
    if not config.rope:
        x = x + params["pos"][pos][:, None, :]
    slots = torch.arange(table.shape[1] * W, device=tok.device)[None, :]
    mask = (slots <= pos[:, None])[:, None, None, :]  # (B, 1, 1, NW*W)
    kv_io = _PagedKernelKV(table, W, pos) if backend == "cuda" else _PagedKV(table, W)
    logits, pool = _run_blocks(params, x, pool, pos, mask, config, kv_io=kv_io)
    return logits[:, 0], pool


def _pool_block_size(pool) -> int:
    """Block width W of a pool in either storage format."""
    return _values(pool["k"]).shape[2]


def make_paged_prefill(config: BurninConfig, prompt_slots: int, window: int):
    """Block-table prefill: returns ``prefill(params, prompt, lens_c,
    pool, table, first_window=0) -> (last, pool)``, which runs the padded
    prompt's W-token windows ``[first_window, prompt_slots/W)`` in order,
    each writing its KV into block ``table[:, i]`` (in place) and
    attending over the table-gathered pool.  ``last`` (B, vocab) holds
    each row's logits at its own last real position ``lens_c[b] - 1``.
    Windows of trailing pads write garbage into the row's own decode
    blocks (overwritten by decode before the mask reaches them) or into
    scratch."""
    c = config
    _check_prefix_window(c, prompt_slots, window)
    W = window
    nwin = prompt_slots // W

    def prefill(params, prompt, lens_c, pool, table, first_window=0):
        if not 0 <= first_window < nwin:
            raise ValueError(f"first_window must be in [0, {nwin}), got {first_window}")
        dev = prompt.device
        t_eff = table.shape[1] * W
        kv = _PagedKV(table, W)
        lens_c = lens_c.long()
        last = torch.zeros((prompt.shape[0], c.vocab), device=dev)
        for i in range(first_window, nwin):
            p0 = i * W
            x = _embed_lookup(params["embed"], prompt[:, p0:p0 + W])
            if not c.rope:
                x = x + params["pos"][None, p0:p0 + W, :]
            valid = (
                torch.arange(t_eff, device=dev)[None, :]
                <= p0 + torch.arange(W, device=dev)[:, None]
            )  # (W, NW*W)
            logits, pool = _run_blocks(params, x, pool, p0, valid[None, None], c, kv_io=kv)
            off = lens_c - 1 - p0  # last real position, window-relative
            cand = logits[torch.arange(prompt.shape[0], device=dev), off.clamp(0, W - 1)]
            hit = (off >= 0) & (off < W)
            last = torch.where(hit[:, None], cand, last)
        return last, pool

    return prefill


class BlockAllocator:
    """Host-side free list + per-block refcounts over a block pool (the
    reference's allocator without its telemetry records).

    Block 0 is the SCRATCH block: never handed out, permanently
    referenced.  ``alloc`` hands out blocks at refcount 1; ``ref`` adds
    an owner; ``unref`` drops one and returns the block to the free list
    at zero.  The free list is LIFO with low ids first out."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"allocator needs >= 2 blocks (block 0 is scratch), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self._ref = [0] * num_blocks
        self._ref[0] = 1  # scratch: immortal, never in the free list
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        """Blocks owned by at least one table cell (scratch excluded)."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def aliased_count(self) -> int:
        """Blocks with more than one owner."""
        return sum(1 for r in self._ref[1:] if r >= 2)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def alloc(self, n: int) -> "list[int] | None":
        """``n`` fresh blocks at refcount 1, or None (and no allocation)
        when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def ref(self, blocks) -> None:
        for b in blocks:
            if b == 0 or self._ref[b] <= 0:
                raise RuntimeError(f"ref of unowned block {b} (scratch or free)")
        for b in blocks:
            self._ref[b] += 1

    def unref(self, blocks) -> None:
        for b in blocks:
            if b == 0 or self._ref[b] <= 0:
                raise RuntimeError(f"unref of unowned block {b} (scratch or free)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)

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

    def stats(self) -> "dict[str, int]":
        return {
            "blocks_total": self.num_blocks,
            "blocks_free": self.free_count,
            "blocks_allocated": self.allocated_count,
            "blocks_aliased": self.aliased_count,
        }
