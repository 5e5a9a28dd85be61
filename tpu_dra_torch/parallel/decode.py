"""KV-cache decode for the burn-in LM: the incremental serving path.

Counterpart of `tpu_dra.parallel.decode` for the greedy, single-device
path: the cache (bf16, or int8 with a scale per token and head), the
per-layer decode block, the per-row decode step the engine runs, and the
greedy pick.  Params may be int8 (`quant.quantize_params`): each layer's
``{"q","s"}`` leaves are dequantized to bf16 when the layer runs, and
the embedding table when the logits need it.  Where the reference returns
a new cache, these functions write the cache IN PLACE (``index_put_``
or slice assignment into the stacked ``(L, ...)`` buffers) and return
the same object: PyTorch has no donation, and a serving cache is the
largest tensor there is.

The ``kv_io`` seam is the reference's: an object with ``write(buf, new,
p0) -> buf`` and ``read(buf) -> (B, T, H, K)`` swaps the cache
addressing without touching the math (`paged._PagedKV` reads and writes
through a block table), and one that also defines ``attend(q, ck, cv)``
owns the whole attention contraction (`paged._PagedKernelKV`, the CUDA
paged-attention kernel).
"""

from __future__ import annotations

import torch

from tpu_dra_torch.parallel.burnin import (
    BurninConfig,
    _attend_dense,
    _logits,
    _matmul_bf16,
    _mlp,
    _rms_norm,
    rope_apply,
    rope_tables,
)
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.quant import (
    dequantize,
    dequantize_bf16,
    is_quantized_leaf,
    quantize_tensor,
)

__all__ = [
    "decode_step_rows",
    "init_cache",
]


def init_cache(config: BurninConfig, batch: int, kv_int8: bool = False,
               device: "str | torch.device" = "cuda"):
    """Zeroed KV cache: ``{"k","v"}`` of (L, B, T, H, d_head) bf16 with T
    the model's full context (``config.seq``).  ``kv_int8=True`` stores
    each leaf as ``{"q": int8 (L, B, T, H, K), "s": f32 (L, B, T, H, 1)}``:
    rows are quantized once at insert, one scale per token and head."""
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, batch, c.seq, c.n_heads, c.d_head)
    return {name: _zeros_kv(shape, kv_int8, dev) for name in ("k", "v")}


def _zeros_kv(shape, kv_int8: bool, dev):
    """One zeroed KV leaf: bf16, or the int8 ``{"q","s"}`` pair."""
    if not kv_int8:
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    return {
        "q": torch.zeros(shape, dtype=torch.int8, device=dev),
        "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
    }


def _layer(leaf, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` leaf or ``{"q","s"}`` pair
    (views, so in-place writes reach the stack)."""
    if is_quantized_leaf(leaf):
        return {"q": leaf["q"][i], "s": leaf["s"][i]}
    return leaf[i]


def _values(buf):
    """The value tensor of a bf16 buffer or of an int8 ``{"q","s"}`` pair."""
    return buf["q"] if is_quantized_leaf(buf) else buf


def _kv_writes(buf, new):
    """``new`` (..., H, K) in ``buf``'s storage, as (target, update)
    tensor pairs: one for a bf16 buffer; the values and the scales for an
    int8 pair, ``new`` quantized over d_head (one scale per token and
    head) once, here."""
    if is_quantized_leaf(buf):
        row = quantize_tensor(new, (3,))
        return [(buf["q"], row["q"]), (buf["s"], row["s"])]
    return [(buf, new.to(torch.bfloat16))]


def _cache_update(cbuf, new, p0):
    """Write ``new`` (B, S, H, K) into slots [p0, p0+S) of ``cbuf`` (B,
    T, H, K), bf16 or an int8 pair, in place.  A (B,) tensor ``p0`` gives
    per-row slots (S must be 1): the engine's rows sit at different
    positions."""
    per_row = torch.is_tensor(p0) and p0.dim() >= 1
    if per_row and new.shape[1] != 1:
        raise ValueError(
            f"per-row cache writes are single-token (S=1), got S={new.shape[1]}"
        )
    rows = torch.arange(new.shape[0], device=new.device)
    for buf, upd in _kv_writes(cbuf, new):
        if per_row:
            buf.index_put_((rows, p0.long()), upd[:, 0])
        else:
            buf[:, p0:p0 + upd.shape[1]] = upd
    return cbuf


def _cache_len(cache) -> int:
    """Context length T of a cache in either storage format."""
    return _values(cache["k"]).shape[2]


def _embed_lookup(emb, idx):
    """Token embedding rows of a plain (V, D) bf16 or f32 table, or f32
    rows ``q[idx] * s[idx]`` of an int8 ``{"q","s"}`` one (the
    dequantized table is never built)."""
    if is_quantized_leaf(emb):
        return dequantize({"q": emb["q"][idx], "s": emb["s"][idx]})
    if not torch.is_tensor(emb) or emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            "embedding must be a bf16 or f32 tensor or an int8 {'q','s'} pair"
        )
    return emb[idx]


def _decode_block(layer, x, ck, cv, p0, *, config: BurninConfig, mask,
                  rope_tab=None, kv_io=None):
    """One block over ``x`` (B, S, d) written to cache slots [p0, p0+S):
    K/V land in ``ck``/``cv`` (in place, through ``kv_io`` when given)
    and the queries attend under ``mask`` (broadcastable to (B, 1, S,
    T)) — the training block's arithmetic, minus gradients."""
    c = config
    h = _rms_norm(x, layer["ln1"]).to(torch.bfloat16)
    qkv = _matmul_bf16(h, layer["wqkv"], 1)  # (B, S, 3, H, K)
    q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if c.rope:
        # Rotated K goes INTO the cache, so reads never re-rotate.
        q = rope_apply(q, rope_tab)
        k_new = rope_apply(k_new, rope_tab)

    if kv_io is None:
        ck = _cache_update(ck, k_new, p0)
        cv = _cache_update(cv, v_new, p0)
        att = _attend_dense(q, dequantize_bf16(ck), dequantize_bf16(cv), mask, c.d_head)
    else:
        ck = kv_io.write(ck, k_new, p0)
        cv = kv_io.write(cv, v_new, p0)
        if hasattr(kv_io, "attend"):
            # The kv_io owns the contraction (the paged-attention kernel):
            # KV is read block by block, never gathered, and the causal
            # mask lives on its per-row positions.
            att = kv_io.attend(q, ck, cv)
        else:
            att = _attend_dense(q, kv_io.read(ck), kv_io.read(cv), mask, c.d_head)
    x = x + _matmul_bf16(att, layer["wo"], 2)
    return _mlp(layer, x), ck, cv


def _run_blocks(params, x, cache, p0, mask, config: BurninConfig, kv_io=None):
    """Every layer, the final norm and the logits over embedded inputs
    ``x`` (B, S, d); ``cache`` holds stacked (L, ...) ``k``/``v`` leaves —
    a row cache or a block pool, bf16 or int8 pairs — updated in place.
    Returns ``(logits (B, S, vocab) f32, cache)``."""
    rope_tab = None
    if config.rope:
        # Slot == sequence position on every rope path: per-row p0 (B,)
        # with S == 1, or a scalar window start.
        if torch.is_tensor(p0) and p0.dim() >= 1:
            positions = p0[:, None]
        else:
            positions = p0 + torch.arange(x.shape[1], device=x.device)
        rope_tab = rope_tables(positions, config.d_head)
    for i in range(config.n_layers):
        # An int8 layer's {"q","s"} matrices become bf16 here, one layer
        # at a time: the reference's dequantize-at-use in its layer scan.
        layer = {n: dequantize_bf16(_layer(leaf, i)) for n, leaf in params["layers"].items()}
        x, _, _ = _decode_block(
            layer, x, _layer(cache["k"], i), _layer(cache["v"], i), p0,
            config=config, mask=mask, rope_tab=rope_tab, kv_io=kv_io,
        )
    return _logits(params, x), cache


def decode_step_rows(params, tok, cache, pos, config: BurninConfig):
    """One decode step with PER-ROW positions: row ``b``'s token
    ``tok[b]`` lands in cache slot ``pos[b]`` (in place) and attends
    slots ``j <= pos[b]``.  Returns ``(logits (B, vocab), cache)``."""
    T = _cache_len(cache)
    x = _embed_lookup(params["embed"], tok)[:, None, :]
    if not config.rope:
        x = x + params["pos"][pos][:, None, :]
    slots = torch.arange(T, device=tok.device)[None, :]
    mask = (slots <= pos[:, None])[:, None, None, :]  # (B, 1, 1, T)
    logits, cache = _run_blocks(params, x, cache, pos, mask, config)
    return logits[:, 0], cache


def _check_window(c: BurninConfig, first: int, steps: int, name: str) -> None:
    if not 0 < first < c.seq:
        raise ValueError(f"{name} must be in (0, {c.seq}), got {first}")
    if steps < 1 or first + steps > c.seq:
        raise ValueError(
            f"{name} + steps must fit the context {c.seq}, got "
            f"{first} + {steps}"
        )


def _check_prefix_window(c: BurninConfig, prompt_slots: int, window: int) -> None:
    if not 1 <= window <= prompt_slots or prompt_slots % window != 0:
        raise ValueError(
            f"prefix window must divide prompt_slots, got "
            f"{window} vs {prompt_slots}"
        )


def _make_pick(sampled: bool):
    """The token pick: greedy argmax (the first maximum on ties, as
    ``jnp.argmax``), int32.  Sampling is not ported yet."""
    if sampled:
        raise ValueError("sampled decoding is not ported yet: greedy only")

    def pick(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return pick


def _chosen_logprob(logits, tok):
    """The raw model log-probability of ``tok`` (B,) under ``logits``
    (B, vocab): log-softmax in f32 at the chosen token."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(-1, tok.long()[:, None])[:, 0]
