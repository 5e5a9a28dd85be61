"""KV-cache decode for the burn-in LM: the incremental serving path.

Counterpart of `tpu_dra.parallel.decode`, on one device or on a mesh of
ranks (below): the cache (bf16,
or int8 with a scale per token and head), the per-layer decode block
(dense or with switch-routed experts), the per-row decode step the
engine's rows layout runs, the contiguous-cache forward
(`decode_forward`), the generation factories over it (`make_generate`,
`make_generate_padded`, and `make_prefill` + `make_generate_from_cache`
with `expand_cache` for one prefill fanned out to many continuations;
`generate` for one call), the row copies of the rows layout's prefix
cache (`copy_prefix_into_row` and the suffix prefill), and the decoding
policy:
greedy argmax, or temperature-scaled sampling restricted by top-k/top-p
(`filter_logits`) and drawn with JAX's own Threefry (`prng`), so that a
key gives the reference's tokens.  Params may be int8
(`quant.quantize_params`): each layer's ``{"q","s"}`` leaves are
dequantized to bf16 when the layer runs, and the embedding table when
the logits need it.  Where the reference returns
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

On a mesh (a `DeviceMesh` of ``data``, ``fsdp``, ``model`` and
optionally ``expert``, one process a rank: ``mesh=`` on the step
functions, the generation factories and `init_cache`) the layout is the
training layout minus the sequence dimension, as the reference's:

- the batch over ``data`` x ``fsdp`` (data major), where it divides
  their product; a batch that does not (a B=1 admission prefill, a wave
  of 3 on 4 ranks) is replicated over them, never padded (`_Rows`);
- heads, and the cache's head dim, over ``model`` (`cache_spec`);
- the residual stream whole over ``model``;
- weights as `burnin.param_specs` (or `quant.quant_param_specs`) lay
  them out, each matrix all-gathered over ``fsdp`` at its use (an int8
  pair as it is stored, then dequantized); the column-parallel qkv
  product gives the rank's heads, which attend over its heads' cache;
  the row-parallel ``wo`` and ``w2`` products are partial sums, summed
  over ``model`` (`spmd.psum`);
- the embedding table is ``(vocab / fsdp, d / model)`` a rank: a token is
  looked up in the rank's vocab block, summed over ``fsdp`` and gathered
  over ``model``; the logits are the rank's vocab block from its ``d /
  model`` slice, summed in f32 over ``model``, rounded to bf16 and
  all-gathered over ``fsdp`` (the whole f32 table is never gathered).

The step functions take the global tokens and positions (every rank
passes the same) and the rank's cache, and return the rank's rows of the
logits.  The factories take the global prompt and return the global
tokens on every rank: a step's picks are made on the rows of the rank's
``fsdp`` group, which the logits' gather leaves there, and one
all-gather over ``data`` makes them global.  A sampled pick with one key
draws the global ``(B, vocab)`` Threefry bits and takes its rows, so the
tokens are the one device's bit for bit wherever the logits are.  On one
rank every collective is the identity and the arithmetic is the one
device's.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_dra_torch.parallel import prng, spmd
from tpu_dra_torch.parallel.burnin import (
    BurninConfig,
    _attend_dense,
    _logits,
    _matmul_bf16,
    _mlp,
    _rms_norm,
    bf16_scalar,
    param_specs,
    rope_apply,
    rope_tables,
)
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.moe import expert_capacity, moe_mlp_sharded
from tpu_dra_torch.parallel.quant import (
    dequantize,
    dequantize_bf16,
    is_quantized,
    is_quantized_leaf,
    quant_param_specs,
    quantize_tensor,
)
from tpu_dra_torch.utils import trace

__all__ = [
    "cache_spec",
    "copy_prefix_into_row",
    "decode_forward",
    "decode_step_padded",
    "decode_step_rows",
    "expand_cache",
    "filter_logits",
    "generate",
    "init_cache",
    "make_generate",
    "make_generate_from_cache",
    "make_generate_padded",
    "make_prefill",
    "serving_config",
]

# The profiler range over each decode block's attention half, eager or
# replayed from a captured graph (`paged.DecodeGraphs`).
ATTN_RANGE = "decode.attn"

def serving_config(config: BurninConfig) -> BurninConfig:
    """The serving view of a training config: the training-only
    parallelism (ring/Ulysses context parallelism, pipeline stages)
    stripped, everything the params depend on untouched: ring-,
    Ulysses- and pipeline-trained weights serve under the config this
    returns."""
    return dataclasses.replace(
        config, ring_attention=False, ulysses_attention=False, pipeline_stages=0,
    )


# The reference's refusal of a pipelined config (`_validate`), which
# `models.serve_family` reports for the pipelined family on a mesh.
PIPELINE_REFUSAL = (
    "decode does not run under pipeline parallelism: a one-token "
    "step has no microbatch stream to fill a GPipe schedule with "
    "— serve the pp-trained weights via serving_config(config)"
)


def _validate(config: BurninConfig) -> None:
    """The reference's decode refusals: no context or pipeline
    parallelism (a one-token step has neither a sequence to shard nor a
    microbatch stream)."""
    if config.ring_attention or config.ulysses_attention:
        raise ValueError(
            "decode does not run under context parallelism: ring/Ulysses "
            "shard the sequence, and a decode step has a single query "
            "position — serve the cp-trained weights via "
            "serving_config(config) (same param geometry, tp mesh)"
        )
    if config.pipeline_stages > 0:
        raise ValueError(PIPELINE_REFUSAL)


class _Rows:
    """Where the rows of a batch of ``batch`` lie on a serving mesh
    (``place``, a `spmd.Place`).  Over ``data`` x ``fsdp``, data major,
    when the batch divides their product (``split``): the rank computes
    rows ``[lo, hi)``, and the rank's ``fsdp`` group (every rank with its
    place on ``data``) rows ``[glo, ghi)``.  Otherwise every rank holds
    every row (replicated; a batch is never padded), and both ranges are
    the whole batch."""

    def __init__(self, place: "spmd.Place", batch: int):
        self.place, self.batch = place, batch
        data, fsdp = place.size("data"), place.size("fsdp")
        self.split = data * fsdp > 1 and batch % (data * fsdp) == 0
        if self.split:
            group = batch // data
            self.glo = place.index("data") * group
            self.lo = self.glo + place.index("fsdp") * (group // fsdp)
            self.ghi, self.hi = self.glo + group, self.lo + group // fsdp
        else:
            self.glo = self.lo = 0
            self.ghi = self.hi = batch

    def own(self, x):
        """The rank's rows of a global (B, ...) tensor."""
        return x[self.lo:self.hi]

    def group(self, x):
        """The group's rows of a global (B, ...) tensor."""
        return x[self.glo:self.ghi]

    def own_of_group(self, x):
        """The rank's rows of the group's."""
        return x[self.lo - self.glo:self.hi - self.glo]

    def to_group(self, x):
        """The group's rows from each rank's own: an all-gather over ``fsdp``."""
        return spmd.gather(x, self.place, "fsdp", 0) if self.split else x

    def to_global(self, x):
        """Every row from each group's: an all-gather over ``data``."""
        return spmd.gather(x, self.place, "data", 0) if self.split else x

    def all_true(self, flag):
        """A device bool over the group's rows made one over every row."""
        if not self.split or self.place.size("data") == 1:
            return flag
        bad = (~flag).to(torch.float32).reshape(1)
        return spmd.psum(bad, self.place, "data")[0] == 0


def _place(mesh) -> "spmd.Place | None":
    return None if mesh is None else spmd.Place(mesh)


def _rows(place, batch: int) -> "_Rows | None":
    return None if place is None else _Rows(place, batch)


def _to_global(x, rows):
    return x if rows is None else rows.to_global(x)


def cache_spec(config: BurninConfig, kv_int8: bool = False):
    """The cache's layout on a mesh (the port's spec: an entry a dim):
    the batch over ``data`` x ``fsdp``, the heads over ``model``, the
    context whole (every step reads all of it); with ``kv_int8`` the
    ``{"q","s"}`` pair of it (the scale's size-1 dim unsharded)."""
    spec = (None, ("data", "fsdp"), None, "model", None)
    return {"q": spec, "s": spec} if kv_int8 else spec


def _local_heads(config: BurninConfig, place: "spmd.Place") -> int:
    model = place.size("model")
    if config.n_heads % model:
        raise ValueError(f"n_heads {config.n_heads} does not split over model ({model} ways)")
    return config.n_heads // model


def _kv_cache(config: BurninConfig, batch: int, heads: int, kv_int8: bool, dev):
    shape = (config.n_layers, batch, config.seq, heads, config.d_head)
    return {name: _zeros_kv(shape, kv_int8, dev) for name in ("k", "v")}


def init_cache(config: BurninConfig, batch: int, kv_int8: bool = False,
               device: "str | torch.device" = "cuda", mesh=None):
    """Zeroed KV cache: ``{"k","v"}`` of (L, B, T, H, d_head) bf16 with T
    the model's full context (``config.seq``).  ``kv_int8=True`` stores
    each leaf as ``{"q": int8 (L, B, T, H, K), "s": f32 (L, B, T, H, 1)}``:
    rows are quantized once at insert, one scale per token and head.

    On a ``mesh`` it is the rank's block of `cache_spec`'s layout, on the
    rank's device (``device`` is not read): (L, B / (data x fsdp), T, H /
    model, K), the batch whole where it does not divide data x fsdp."""
    if mesh is None:
        return _kv_cache(config, batch, config.n_heads, kv_int8, resolve_device(device))
    place = spmd.Place(mesh)
    rows = _Rows(place, batch)
    return _kv_cache(config, rows.hi - rows.lo, _local_heads(config, place), kv_int8,
                     place.device)


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


def _kv_tensors(cache):
    """Every tensor of a cache, in one fixed order: ``k`` then ``v``,
    each a bf16 tensor or its int8 values then scales.  Every one carries
    the batch on axis 1 and the position on axis 2."""
    out = []
    for name in ("k", "v"):
        leaf = cache[name]
        out += [leaf["q"], leaf["s"]] if is_quantized_leaf(leaf) else [leaf]
    return out


def copy_prefix_into_row(dst, dst_row: int, src, src_row: int, length: int):
    """Copy positions ``[0, length)`` of batch row ``src_row`` of cache
    ``src`` into batch row ``dst_row`` of cache ``dst`` (in place; the
    destination's later positions are left as they are) and return
    ``dst``.  Both caches have one storage format, bf16 or int8.  A
    causal KV entry at position j depends only on tokens [0, j], so the
    first ``length`` positions of a resident prefix row serve any
    request sharing those tokens: the device half of the rows layout's
    prefix cache.  With ``length`` the context, it is the engine's
    whole-row insert."""
    for d, s in zip(_kv_tensors(dst), _kv_tensors(src)):
        d[:, dst_row, :length] = s[:, src_row, :length]
    return dst


def expand_cache(cache, last_logits, n: int):
    """Tile a prefilled prefix across the batch: each of the B rows
    becomes ``n`` consecutive identical rows (axis 1 of every cache
    tensor, axis 0 of the logits); new tensors, the inputs untouched."""
    def rows(leaf):
        if is_quantized_leaf(leaf):
            return {k: t.repeat_interleave(n, dim=1) for k, t in leaf.items()}
        return leaf.repeat_interleave(n, dim=1)

    return {name: rows(leaf) for name, leaf in cache.items()}, last_logits.repeat_interleave(n, dim=0)


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
    T)) — the training block's arithmetic, minus gradients.  The expert
    MLP's queues hold ``min(S, expert_capacity)`` tokens: the training
    capacity clamped to the tokens present, so a prefill drops where
    training would and a one-token step is dropless."""
    c = config
    S = x.shape[1]
    x, ck, cv = _attn_half(layer, x, ck, cv, p0, c, mask, rope_tab, kv_io)
    capacity = min(S, expert_capacity(c)) if c.moe_experts > 0 else None
    x, _ = _mlp(layer, x, c, capacity)
    return x, ck, cv


def _attn_half(layer, x, ck, cv, p0, c: BurninConfig, mask, rope_tab, kv_io):
    """A decode block's attention half, its residual added: `_attention`
    and the ``wo`` product.  Under a profiler it is the `ATTN_RANGE`
    range.  Returns ``(x, ck, cv)``."""
    with trace.range(ATTN_RANGE):
        att, ck, cv = _attention(layer, x, ck, cv, p0, c, mask, rope_tab, kv_io)
        return x + _matmul_bf16(att, layer["wo"], 2), ck, cv


def _attention(layer, x, ck, cv, p0, c: BurninConfig, mask, rope_tab, kv_io):
    """The attention half of a decode block up to the ``wo`` product:
    the pre-norm qkv product (on a mesh, the rank's heads), K/V written
    to the cache slots at ``p0`` and the queries attended.  Returns
    ``(att (B, S, H, K) bf16, ck, cv)``."""
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
    return att, ck, cv


def _run_blocks(params, x, cache, p0, mask, config: BurninConfig, kv_io=None):
    """Every layer, the final norm and the logits over embedded inputs
    ``x`` (B, S, d); ``cache`` holds stacked (L, ...) ``k``/``v`` leaves —
    a row cache or a block pool, bf16 or int8 pairs — updated in place.
    Returns ``(logits (B, S, vocab) f32, cache)``."""
    rope_tab = _rope_tab(config, p0, x)
    for i in range(config.n_layers):
        # An int8 layer's {"q","s"} matrices become bf16 here, one layer
        # at a time: the reference's dequantize-at-use in its layer scan.
        layer = {n: dequantize_bf16(_layer(leaf, i)) for n, leaf in params["layers"].items()}
        x, _, _ = _decode_block(
            layer, x, _layer(cache["k"], i), _layer(cache["v"], i), p0,
            config=config, mask=mask, rope_tab=rope_tab, kv_io=kv_io,
        )
    return _logits(params, x), cache


def _rope_tab(config: BurninConfig, p0, x):
    """The rope tables of the ``x.shape[1]`` incoming tokens (None
    without rope).  Slot == sequence position on every rope path: per-row
    ``p0`` (B,) with S == 1, or a scalar window start."""
    if not config.rope:
        return None
    if torch.is_tensor(p0) and p0.dim() >= 1:
        positions = p0[:, None]
    else:
        positions = p0 + torch.arange(x.shape[1], device=x.device)
    return rope_tables(positions, config.d_head)


# -- the mesh forms of the embedding, the block and the logits --------------


def _no_fsdp(spec):
    return tuple(None if e == "fsdp" else e for e in spec)


def _layer_specs(params, config: BurninConfig, place: "spmd.Place"):
    """Each layer leaf's spec without the layer dim (an int8 leaf's the
    ``{"q","s"}`` pair of them)."""
    specs = (quant_param_specs if is_quantized(params) else param_specs)(config, place.sizes)

    def drop(spec):
        return {k: v[1:] for k, v in spec.items()} if isinstance(spec, dict) else spec[1:]

    return {name: drop(spec) for name, spec in specs["layers"].items()}


def _whole(leaf, spec, place: "spmd.Place"):
    """A layer leaf's shard made whole over ``fsdp`` at its use: a plain
    leaf in its own dtype; an int8 pair's values and scales gathered as
    they are stored (half the bytes of gathering bf16), then dequantized
    to bf16 — the same values as dequantizing the whole pair."""
    if is_quantized_leaf(leaf):
        return dequantize_bf16({"q": spmd.gather_leaf(leaf["q"], spec["q"], place),
                                "s": spmd.gather_leaf(leaf["s"], spec["s"], place)})
    return spmd.gather_leaf(leaf, spec, place)


def _embed_mesh(params, tokens, pos_emb, rows: _Rows):
    """The rank's rows of the embedded inputs, (B_rank, S, d) f32, from
    the global ``tokens`` (B, S): each token looked up in the rank's vocab
    block of its (vocab / fsdp, d / model) table, zero where another
    block holds it, summed over ``fsdp`` (a reduce-scatter to the rank's
    rows, or an all-reduce when the batch is replicated: exact, one term
    is not zero), ``pos_emb`` (the rank's rows of the position table's d
    / model columns, or None) added, then gathered over ``model``."""
    place = rows.place
    emb = params["embed"]
    n_v = _values(emb).shape[0]
    local = rows.group(tokens).long() - place.index("fsdp") * n_v
    inb = (local >= 0) & (local < n_v)
    x = _embed_lookup(emb, local.clamp(0, n_v - 1)).masked_fill(~inb[..., None], 0.0)
    x = spmd.scatter(x, place, "fsdp", 0) if rows.split else spmd.psum(x, place, "fsdp")
    if pos_emb is not None:
        x = x + pos_emb
    return spmd.gather(x, place, "model", x.dim() - 1)


def _logits_mesh(params, x, rows: _Rows):
    """Logits f32 (B_group, S, vocab) of the rank's ``fsdp`` group's rows
    from its rows of the stream ``x``: the final norm, its bf16 rows
    gathered over ``fsdp``, the product of their ``d / model`` slice with
    the rank's (vocab / fsdp, d / model) table summed in f32 over
    ``model`` and rounded to bf16 once (on one ``model`` rank, the one
    device's bf16 product), then the vocab gathered over ``fsdp``."""
    place = rows.place
    h = rows.to_group(_rms_norm(x, params["ln_f"]).to(torch.bfloat16))
    emb = dequantize_bf16(params["embed"]).to(torch.bfloat16)
    n_d = emb.shape[1]
    d0 = place.index("model") * n_d
    h = h[..., d0:d0 + n_d]
    if place.size("model") == 1:
        part = h @ emb.T
    else:
        part = spmd.psum(h.float() @ emb.float().T, place, "model").to(torch.bfloat16)
    return spmd.gather(part, place, "fsdp", part.dim() - 1).float()


def _decode_block_mesh(layer, x, ck, cv, p0, *, config: BurninConfig, mask, place, specs,
                       rope_tab=None, kv_io=None):
    """`_decode_block` on a rank: ``layer`` its weights made whole over
    ``fsdp`` (`_whole`; ``specs`` their layouts so), its heads in the
    qkv product and in ``ck``/``cv``; ``x`` (B_rank, S, d) whole over
    ``model``.  The ``wo`` and ``w2`` products are partial sums over the
    rank's heads and hidden units, summed over ``model``; the expert MLP
    is `moe.moe_mlp_sharded`'s serving form."""
    c = config
    S = x.shape[1]
    att, ck, cv = _attention(layer, x, ck, cv, p0, c, mask, rope_tab, kv_io)
    x = x + spmd.psum(_matmul_bf16(att, layer["wo"], 2), place, "model")
    h = _rms_norm(x, layer["ln2"]).to(torch.bfloat16)
    if c.moe_experts > 0:
        out, _ = moe_mlp_sharded(layer, h, c, place, specs,
                                 capacity=min(S, expert_capacity(c)), serve=True)
        return x + out, ck, cv
    h = _matmul_bf16(h, layer["w1"], 1)
    h = torch.where(h > 0, h, bf16_scalar(0.01) * h)
    return x + spmd.psum(_matmul_bf16(h, layer["w2"], 1), place, "model"), ck, cv


def _run_blocks_mesh(params, x, cache, p0, mask, config: BurninConfig, rows: _Rows,
                     kv_io=None):
    """`_run_blocks` on a rank: its shards of ``params`` and of the
    ``cache`` (or pool), ``x`` its rows of the embedded inputs.  Returns
    ``(logits (B_group, S, vocab) f32 of the rank's fsdp group's rows,
    cache)``."""
    place = rows.place
    specs = _layer_specs(params, config, place)
    whole = {n: _no_fsdp(s["q"] if isinstance(s, dict) else s) for n, s in specs.items()}
    rope_tab = _rope_tab(config, p0, x)
    for i in range(config.n_layers):
        layer = {n: _whole(_layer(leaf, i), specs[n], place)
                 for n, leaf in params["layers"].items()}
        x, _, _ = _decode_block_mesh(
            layer, x, _layer(cache["k"], i), _layer(cache["v"], i), p0, config=config,
            mask=mask, place=place, specs=whole, rope_tab=rope_tab, kv_io=kv_io,
        )
    return _logits_mesh(params, x, rows), cache


def decode_step_rows(params, tok, cache, pos, config: BurninConfig, mesh=None):
    """One decode step with PER-ROW positions: row ``b``'s token
    ``tok[b]`` lands in cache slot ``pos[b]`` (in place) and attends
    slots ``j <= pos[b]``.  Returns ``(logits (B, vocab), cache)``.

    A position past the context (a row of a fused engine call whose
    request finished mid-call steps on) is clamped to the last slot: the
    row writes slot T-1 of its own row, which the next admission's
    whole-row insert overwrites, and its logits are dropped.  The
    reference drops such a write instead; both leave every live row
    alone, and neither ever indexes past the context (on the card that
    would be a device-side assert).

    On a ``mesh``: ``tok`` and ``pos`` are the global (B,) rows, ``cache``
    the rank's (`init_cache` with the mesh), the logits the rank's rows."""
    if mesh is None:
        return _step_rows(params, tok, cache, pos, config)
    rows = _Rows(spmd.Place(mesh), tok.shape[0])
    logits, cache = _step_rows(params, tok, cache, pos, config, rows)
    return rows.own_of_group(logits), cache


def _step_rows(params, tok, cache, pos, config: BurninConfig, rows: "_Rows | None" = None):
    """`decode_step_rows`' body; on a mesh (``rows``) the logits of the
    rank's fsdp group's rows."""
    T = _cache_len(cache)
    pos = pos.clamp(max=T - 1)
    if rows is not None:
        pos = rows.own(pos)
        pos_emb = None if config.rope else params["pos"][pos][:, None, :]
        x = _embed_mesh(params, tok[:, None], pos_emb, rows)
    else:
        x = _embed_lookup(params["embed"], tok)[:, None, :]
        if not config.rope:
            x = x + params["pos"][pos][:, None, :]
    slots = torch.arange(T, device=tok.device)[None, :]
    mask = (slots <= pos[:, None])[:, None, None, :]  # (B, 1, 1, T)
    if rows is not None:
        logits, cache = _run_blocks_mesh(params, x, cache, pos, mask, config, rows)
    else:
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
    if c.moe_experts > 0:
        raise ValueError(
            "the suffix prefill is not supported with moe_experts > 0: "
            "its windowed passes would restart the per-expert capacity "
            "queue, so routing (and drops) would diverge from the one-shot "
            "prefill's — the same invariant that rejects prefill_chunk "
            "(serve MoE with the prefix cache disabled)"
        )


def _validate_filters(vocab: int, sampled: bool, top_k: "int | None",
                      top_p: "float | None") -> None:
    """Build-time filter checks shared by the generate factories and the
    engine: a filter with greedy decoding would be ignored, so it is a
    caller bug."""
    if top_k is None and top_p is None:
        return
    if not sampled:
        raise ValueError(
            "top_k/top_p require temperature > 0 (greedy argmax ignores "
            "the sampling support)"
        )
    if top_k is not None and not 1 <= top_k <= vocab:
        raise ValueError(f"top_k must be in [1, {vocab}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def filter_logits(logits, *, top_k: "int | None" = None,
                  top_p: "float | None" = None):
    """Restrict (..., vocab) logits to their sampling support: tokens
    outside the top-k set and/or the top-p nucleus get -inf.  One stable
    descending sort feeds both filters (equal logits keep index order,
    ``jnp.argsort(-x)``'s order, so top_k=1 keeps the token argmax
    picks); a token stays in the nucleus while the probability mass
    strictly before it is below p (the top token always stays); the keep
    mask is scattered back through the sort's permutation."""
    V = logits.shape[-1]
    _validate_filters(V, True, top_k, top_p)
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    keep_sorted = torch.ones(logits.shape, dtype=torch.bool, device=logits.device)
    if top_k is not None:
        keep_sorted &= torch.arange(V, device=logits.device) < top_k
    if top_p is not None:
        probs = torch.softmax(sorted_logits, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs  # exclusive
        keep_sorted &= before < top_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, -torch.inf)


def _make_pick(sampled: bool, temperature: float = 0.0,
               top_k: "int | None" = None, top_p: "float | None" = None):
    """The token pick ``pick(logits (B, vocab) f32, key=None, rows=None)
    -> (B,) int32``: greedy argmax (the first maximum on ties, as
    ``jnp.argmax``), or the logits divided by ``temperature``, filtered
    (`filter_logits`) and drawn with `prng.categorical` under ``key``
    (one key for the batch, or ``(B, 2)`` keys, one a row).  ``rows``
    (`_Rows`): the logits are the rows of a rank's fsdp group, and one
    key draws over the global batch, so the Gumbel bits are the global
    ``(B, vocab)`` draw's rows."""
    if sampled and not temperature > 0.0:
        raise ValueError(f"sampled decoding needs temperature > 0, got {temperature}")

    def pick(logits, key=None, rows=None):
        if not sampled:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if key is None:
            raise ValueError("temperature > 0 requires a PRNG key: pick(logits, key)")
        scaled = logits / temperature
        if top_k is not None or top_p is not None:
            scaled = filter_logits(scaled, top_k=top_k, top_p=top_p)
        return _categorical(key, scaled, rows).to(torch.int32)

    return pick


def _categorical(key, logits, rows: "_Rows | None" = None):
    """`prng.categorical` of ``logits``, the rows of a rank's fsdp group
    on a mesh (``rows``): under one key its Gumbel draw spans the global
    ``(B, vocab)``, of which these rows take theirs (int64 picks)."""
    if rows is None or not rows.split or torch.as_tensor(key).dim() > 1:
        return prng.categorical(key, logits)
    g = rows.group(prng.gumbel(key, (rows.batch, logits.shape[-1])))
    return torch.argmax(g + logits, dim=-1)


def _make_keys(sampled: bool, key, steps: int, device):
    """One key a generated token: ``split(key, steps)``, or zeros when
    greedy (never read)."""
    if sampled:
        return prng.split(torch.as_tensor(key, dtype=torch.int64, device=device), steps)
    return torch.zeros((steps, 2), dtype=torch.int64, device=device)


def _chosen_logprob(logits, tok):
    """The raw model log-probability of ``tok`` (B,) under ``logits``
    (B, vocab): log-softmax in f32 at the chosen token."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(-1, tok.long()[:, None])[:, 0]


def decode_forward(params, tokens, cache, p0: int, config: BurninConfig, mesh=None):
    """Forward ``tokens`` (B, S) occupying positions [p0, p0+S) against
    the cache (written in place).  Returns ``(logits (B, S, vocab) f32,
    cache)``.  Prefill is ``S = prompt_len, p0 = 0``; a decode step is ``S
    = 1`` at the current position; the speculative verify pass is ``S =
    draft_len + 1`` at the frontier.

    On a ``mesh``: ``tokens`` are the global rows, ``params`` and
    ``cache`` the rank's shards (`weights.shard_params`, `init_cache`
    with the mesh), the logits the rank's rows."""
    if mesh is None:
        return _forward(params, tokens, cache, p0, config)
    rows = _Rows(spmd.Place(mesh), tokens.shape[0])
    logits, cache = _forward(params, tokens, cache, p0, config, rows)
    return rows.own_of_group(logits), cache


def _forward(params, tokens, cache, p0: int, c: BurninConfig, rows: "_Rows | None" = None):
    """`decode_forward`'s body; on a mesh (``rows``) the logits of the
    rank's fsdp group's rows."""
    S = tokens.shape[1]
    T = _cache_len(cache)
    dev = tokens.device
    # Query i sits at position p0 + i and sees slots j <= p0 + i; the
    # zeroed unwritten tail is masked like training's tril.
    valid = torch.arange(T, device=dev)[None, :] <= p0 + torch.arange(S, device=dev)[:, None]
    if rows is not None:
        pos_emb = None if c.rope else params["pos"][p0:p0 + S][None]
        x = _embed_mesh(params, tokens, pos_emb, rows)
        return _run_blocks_mesh(params, x, cache, p0, valid[None, None], c, rows)
    x = _embed_lookup(params["embed"], tokens)
    if not c.rope:
        x = x + params["pos"][p0:p0 + S][None]
    return _run_blocks(params, x, cache, p0, valid[None, None], c)


def _reject_rope_padded(c: BurninConfig) -> None:
    if c.rope:
        raise ValueError(
            "rope is not supported on the padded decode path: its decode "
            "steps write slot prompt_slots + t while the token's logical "
            "position is lens[b] + t, and rope keys on logical position "
            "— serve mixed-length rope requests with the continuous "
            "-batching engine (contiguous rows: slot == position)"
        )


def decode_step_padded(params, tok, cache, lens, prompt_slots: int, t: int,
                       config: BurninConfig, mesh=None):
    """One decode step of a PADDED batch: row ``b``'s prompt filled slots
    [0, lens[b]) (pads trail up to ``prompt_slots``), generated tokens
    take the uniform slots ``prompt_slots + 0..t``.  ``tok`` (B,) lands
    in slot ``prompt_slots + t`` with logical position ``lens[b] + t``;
    row ``b`` sees its real prompt slots and the decode slots so far,
    never its pads.  Returns ``(logits (B, vocab), cache)``; on a
    ``mesh`` as `decode_step_rows` says."""
    if mesh is None:
        return _step_padded(params, tok, cache, lens, prompt_slots, t, config)
    rows = _Rows(spmd.Place(mesh), tok.shape[0])
    logits, cache = _step_padded(params, tok, cache, lens, prompt_slots, t, config, rows)
    return rows.own_of_group(logits), cache


def _step_padded(params, tok, cache, lens, prompt_slots: int, t: int, c: BurninConfig,
                 rows: "_Rows | None" = None):
    """`decode_step_padded`'s body; on a mesh (``rows``) the logits of the
    rank's fsdp group's rows."""
    _reject_rope_padded(c)
    T = _cache_len(cache)
    if rows is not None:
        lens = rows.own(lens)
        pos_emb = params["pos"][(lens + t).long()]
        x = _embed_mesh(params, tok[:, None], pos_emb[:, None, :], rows)
    else:
        pos_emb = params["pos"][(lens + t).long()]  # (B, d): logical, per row
        x = _embed_lookup(params["embed"], tok)[:, None, :] + pos_emb[:, None, :]
    slots = torch.arange(T, device=tok.device)[None, :]
    visible = (slots < lens[:, None]) | ((slots >= prompt_slots) & (slots <= prompt_slots + t))
    mask = visible[:, None, None, :]
    if rows is not None:
        logits, cache = _run_blocks_mesh(params, x, cache, prompt_slots + t, mask, c, rows)
    else:
        logits, cache = _run_blocks(params, x, cache, prompt_slots + t, mask, c)
    return logits[:, 0], cache


def _check_chunk(c: BurninConfig, prompt_len: int, prefill_chunk: "int | None",
                 name: str = "prompt_len") -> None:
    if prefill_chunk is not None and (prefill_chunk < 1 or prompt_len % prefill_chunk != 0):
        raise ValueError(
            f"prefill_chunk must divide {name}, got {prefill_chunk} vs {prompt_len}"
        )
    if prefill_chunk is not None and prefill_chunk != prompt_len and c.moe_experts > 0:
        raise ValueError(
            "prefill_chunk is not supported with moe_experts > 0: each "
            "window would restart the per-expert capacity queue, so "
            "chunked routing (and drops) would diverge from the one-shot "
            "prefill's — breaking the drops-exactly-when-training-would "
            "serving invariant (chunk the attention, not the router)"
        )


def _prefill_windows(params, prompt, lens_c, cache, window: int, first: int,
                     c: BurninConfig, rows: "_Rows | None" = None):
    """The padded prompt's ``window``-token windows from window ``first``
    on, each at its absolute offset, into ``cache``; returns ``(last (B,
    vocab), cache)``, ``last`` each row's logits at its own last real
    position ``lens_c[b] - 1`` (picked out of whichever window covers it;
    zeros if none of the windows run does); on a mesh (``rows``) the rows
    of the rank's fsdp group."""
    lens_c = lens_c if rows is None else rows.group(lens_c)
    idx = torch.arange(lens_c.shape[0], device=prompt.device)
    last_pos = lens_c.long() - 1
    W = window
    last = torch.zeros((lens_c.shape[0], c.vocab), device=prompt.device)
    for i in range(first, prompt.shape[1] // W):
        logits, cache = _forward(params, prompt[:, i * W:(i + 1) * W], cache, i * W, c, rows)
        off = last_pos - i * W  # the row's last real position, window-relative
        cand = logits[idx, off.clamp(0, W - 1)]
        last = torch.where(((off >= 0) & (off < W))[:, None], cand, last)
    return last, cache


def _build_prefill_padded(c: BurninConfig, prompt_slots: int, prefill_chunk: "int | None",
                          mesh=None):
    """Padded-batch prefill, one-shot or in ``prefill_chunk``-token
    windows: ``prefill(params, prompt, lens_c, cache) -> (last (B,
    vocab), cache)``, ``last`` holding each row's logits at its own last
    real position ``lens_c[b] - 1`` (the chunked path picks it out of
    whichever window covers it).  On a ``mesh`` ``prompt`` and ``lens_c``
    are global, ``cache`` the rank's, ``last`` the rows of its fsdp group
    (every row of a batch replicated over data x fsdp)."""
    place = _place(mesh)

    def prefill(params, prompt, lens_c, cache):
        rows = _rows(place, prompt.shape[0])
        if prefill_chunk is None or prefill_chunk == prompt_slots:
            last_pos = (lens_c if rows is None else rows.group(lens_c)).long() - 1
            idx = torch.arange(last_pos.shape[0], device=prompt.device)
            logits, cache = _forward(params, prompt, cache, 0, c, rows)
            return logits[idx, last_pos], cache
        return _prefill_windows(params, prompt, lens_c, cache, prefill_chunk, 0, c, rows)

    return prefill


def _build_prefill_suffix(c: BurninConfig, prompt_slots: int, window: int, mesh=None):
    """The padded prefill on top of a resident prefix: ``prefill(params,
    prompt, lens_c, cache, *, first_window=0) -> (last, cache)`` runs
    only the ``window``-token windows from ``first_window`` on, over a
    cache whose positions ``[0, first_window * window)`` already hold
    the prefix (`copy_prefix_into_row`).  The caller keeps
    ``first_window * window <= min(lens_c) - 1``, so the window of each
    row's last real position runs (a whole-prompt hit still computes
    its last position).  Refused with experts (`_check_prefix_window`).
    On a ``mesh`` as `_build_prefill_padded`."""
    _check_prefix_window(c, prompt_slots, window)
    nwin = prompt_slots // window
    place = _place(mesh)

    def prefill(params, prompt, lens_c, cache, *, first_window: int = 0):
        if not 0 <= first_window < nwin:
            raise ValueError(f"first_window must be in [0, {nwin}), got {first_window}")
        return _prefill_windows(params, prompt, lens_c, cache, window, first_window, c,
                                _rows(place, prompt.shape[0]))

    return prefill


def _build_prefill(c: BurninConfig, prompt_len: int, prefill_chunk: "int | None", mesh=None):
    """Uniform-length prefill, the ``lens == prompt_len`` case of
    `_build_prefill_padded`: ``prefill(params, prompt, cache) -> (last,
    cache)``, shared by `make_generate` and the speculative decoder."""
    padded = _build_prefill_padded(c, prompt_len, prefill_chunk, mesh)

    def prefill(params, prompt, cache):
        lens = torch.full((prompt.shape[0],), prompt_len, dtype=torch.int32,
                          device=prompt.device)
        return padded(params, prompt, lens, cache)

    return prefill


def _token_loop(params, cache, last_logits, pos0: int, keys, pick, c: BurninConfig,
                logprobs: bool = True, rows: "_Rows | None" = None):
    """The generation loop from a prefilled state: pick the first token
    from ``last_logits`` (the logits at position pos0 - 1), then run
    ``len(keys) - 1`` cached decode steps from pos0, all on the device
    with no host sync.  Returns ``(toks (steps-1, B) the tokens fed,
    last (B,) the final pick, lps (B, steps) the raw-model logprob of
    every generated token (None unless ``logprobs``), fin)``, ``fin`` the
    all-logits-finite flag as a device bool.  On a mesh (``rows``) the
    logits are the rank's fsdp group's rows, each step's picks are made
    global by one all-gather over ``data``, and so is everything
    returned."""
    g = pick(last_logits, keys[0], rows)
    lps = [_chosen_logprob(last_logits, g)] if logprobs else None
    tok = _to_global(g, rows)
    fin = torch.isfinite(last_logits).all()
    fed = []
    for i in range(1, keys.shape[0]):
        logits, cache = _forward(params, tok[:, None], cache, pos0 + i - 1, c, rows)
        row = logits[:, -1]
        g = pick(row, keys[i], rows)
        if logprobs:
            lps.append(_chosen_logprob(row, g))
        fin = fin & torch.isfinite(row).all()
        fed.append(tok)
        tok = _to_global(g, rows)
    lps = _to_global(torch.stack(lps, dim=1), rows) if logprobs else None
    if rows is not None:
        fin = rows.all_true(fin)
    return _stack_fed(fed, tok), tok, lps, fin


def _stack_fed(fed, last):
    """The tokens fed to the decode steps as (steps - 1, B) int32 (none
    when one token was generated)."""
    if fed:
        return torch.stack(fed)
    return torch.zeros((0, last.shape[0]), dtype=torch.int32, device=last.device)


def _assemble(prompt, toks, last, fin, with_health: bool):
    """Prompt + (fed tokens, final pick) -> the full output rows."""
    out = torch.cat([toks.transpose(0, 1), last[:, None]], dim=1)
    tokens_out = torch.cat([prompt.to(torch.int32), out], dim=1)
    return (tokens_out, fin) if with_health else tokens_out


def _key_or_raise(sampled: bool, key, signature: str) -> None:
    if sampled and key is None:
        raise ValueError(f"temperature > 0 requires a PRNG key: {signature}")


def make_generate(config: BurninConfig, mesh=None, *, prompt_len: int, steps: int,
                  temperature: float = 0.0, top_k: "int | None" = None,
                  top_p: "float | None" = None, with_health: bool = False,
                  with_logprobs: bool = False, kv_int8: bool = False,
                  prefill_chunk: "int | None" = None):
    """Build ``fn(params, prompt (B, prompt_len) int32[, key]) -> (B,
    prompt_len + steps)`` on one device, or on a ``mesh`` (a
    `DeviceMesh`; every rank calls ``fn`` with its shards of ``params``,
    `weights.shard_params`, and the same global prompt, and gets the
    global tokens).  ``params`` may be plain or int8 as they come (the
    reference's ``quantized`` names the shardings, which the tree
    itself tells here).  A fresh cache (bf16, or int8 with ``kv_int8``)
    on the prompt's device, the prefill (one-shot, or in
    ``prefill_chunk``-token windows, token-exact against one-shot), then
    ``steps - 1`` decode steps, with no host sync.

    Greedy when ``temperature == 0``; otherwise temperature-scaled,
    optionally top-k/top-p filtered sampling under ``key`` (a ``(2,)``
    key, `prng.key`), token ``i`` drawn from ``split(key, steps)[i]``
    over the whole ``(B, vocab)`` batch, as the reference draws.
    ``with_logprobs`` adds the ``(B, steps)`` raw-model logprobs of the
    generated tokens, ``with_health`` the all-logits-finite flag (a
    device bool): ``(tokens[, logprobs][, healthy])``."""
    c = config
    _validate(c)
    _check_window(c, prompt_len, steps, "prompt_len")
    _check_chunk(c, prompt_len, prefill_chunk)
    sampled = temperature > 0.0
    _validate_filters(c.vocab, sampled, top_k, top_p)
    pick = _make_pick(sampled, temperature, top_k, top_p)
    prefill = _build_prefill(c, prompt_len, prefill_chunk, mesh)
    place = _place(mesh)

    @torch.no_grad()
    def run(params, prompt, key=None):
        _key_or_raise(sampled, key, "fn(params, prompt, key)")
        cache = init_cache(c, prompt.shape[0], kv_int8, device=prompt.device, mesh=mesh)
        last_logits, cache = prefill(params, prompt, cache)
        keys = _make_keys(sampled, key, steps, prompt.device)
        toks, last, lps, fin = _token_loop(params, cache, last_logits, prompt_len, keys,
                                           pick, c, logprobs=with_logprobs,
                                           rows=_rows(place, prompt.shape[0]))
        tokens = _assemble(prompt, toks, last, fin, False)
        parts = (tokens,)
        if with_logprobs:
            parts += (lps,)
        if with_health:
            parts += (fin,)
        return parts if len(parts) > 1 else tokens

    return run


def make_generate_padded(config: BurninConfig, mesh=None, *, prompt_slots: int, steps: int,
                         temperature: float = 0.0, top_k: "int | None" = None,
                         top_p: "float | None" = None, with_health: bool = False,
                         kv_int8: bool = False, prefill_chunk: "int | None" = None):
    """Variable-length batches: ``fn(params, prompt (B, prompt_slots),
    lens (B,)[, key]) -> (B, prompt_slots + steps)``, row ``b``'s real
    prompt being ``prompt[b, :lens[b]]`` and the rest of the row padding.
    Pads trail each row, so the uniform prefill is exact; decode steps
    take uniform slots after ``prompt_slots`` at logical positions
    ``lens[b] + t`` (`decode_step_padded`).  Lengths outside ``[1,
    prompt_slots]`` are clamped into it and, with ``with_health``, clear
    the health flag.  Sampling, keys and ``mesh`` as in `make_generate`
    (``lens`` global too)."""
    c = config
    _validate(c)
    _check_window(c, prompt_slots, steps, "prompt_slots")
    _check_chunk(c, prompt_slots, prefill_chunk, "prompt_slots")
    _reject_rope_padded(c)
    sampled = temperature > 0.0
    _validate_filters(c.vocab, sampled, top_k, top_p)
    pick = _make_pick(sampled, temperature, top_k, top_p)
    prefill = _build_prefill_padded(c, prompt_slots, prefill_chunk, mesh)
    place = _place(mesh)

    @torch.no_grad()
    def run(params, prompt, lens, key=None):
        _key_or_raise(sampled, key, "fn(params, prompt, lens, key)")
        rows = _rows(place, prompt.shape[0])
        in_contract = (lens >= 1) & (lens <= prompt_slots)
        lens_c = lens.clamp(1, prompt_slots)
        cache = init_cache(c, prompt.shape[0], kv_int8, device=prompt.device, mesh=mesh)
        last, cache = prefill(params, prompt, lens_c, cache)
        keys = _make_keys(sampled, key, steps, prompt.device)
        tok = _to_global(pick(last, keys[0], rows), rows)
        fin = torch.isfinite(last).all() & in_contract.all()
        fed = []
        for t in range(steps - 1):
            logits, cache = _step_padded(params, tok, cache, lens_c, prompt_slots, t, c, rows)
            nxt = _to_global(pick(logits, keys[t + 1], rows), rows)
            fin = fin & torch.isfinite(logits).all()
            fed.append(tok)
            tok = nxt
        if rows is not None:
            fin = rows.all_true(fin)
        return _assemble(prompt, _stack_fed(fed, tok), tok, fin, with_health)

    return run


def make_prefill(config: BurninConfig, mesh=None, *, prompt_len: int, kv_int8: bool = False,
                 prefill_chunk: "int | None" = None):
    """Prefix caching, step 1: ``fn(params, prompt (B, prompt_len)) ->
    (cache, last_logits)``, a fresh cache (bf16, or int8 with
    ``kv_int8``) on the prompt's device prefilled with the prompt, and
    the logits at its last position.  The state feeds
    `make_generate_from_cache`, which never writes it: one prefill
    serves any number of continuations, and `expand_cache` tiles it
    across a batch.  On a ``mesh`` (as in `make_generate`) the cache is
    the rank's and ``last_logits`` every row's (B, vocab), the same on
    every rank."""
    c = config
    _validate(c)
    _check_window(c, prompt_len, 1, "prompt_len")
    _check_chunk(c, prompt_len, prefill_chunk)
    prefill = _build_prefill(c, prompt_len, prefill_chunk, mesh)
    place = _place(mesh)

    @torch.no_grad()
    def run(params, prompt):
        cache = init_cache(c, prompt.shape[0], kv_int8, device=prompt.device, mesh=mesh)
        last, cache = prefill(params, prompt, cache)
        return cache, _to_global(last, _rows(place, prompt.shape[0]))

    return run


def make_generate_from_cache(config: BurninConfig, mesh=None, *, start_pos: int, steps: int,
                             temperature: float = 0.0, top_k: "int | None" = None,
                             top_p: "float | None" = None, with_health: bool = False,
                             with_logprobs: bool = False):
    """Prefix caching, step 2: ``fn(params, cache, last_logits[, key]) ->
    (B, steps)``, the continuation of a `make_prefill` state whose prompt
    was ``start_pos`` tokens long (the first generated token lands in
    slot ``start_pos``).  The input cache is never written: the decode
    steps run on a copy, so one prefilled state fans out to any number
    of continuations with different keys or filters.  With the same
    length, prefill + continuation gives `make_generate`'s tokens.
    Sampling, keys, ``with_logprobs`` and ``with_health`` as in
    `make_generate`: ``(tokens[, logprobs][, healthy])``.  The cache's
    storage (bf16 or int8) is read from the cache itself (the
    reference's ``kv_int8`` and ``quantized`` arguments name shardings,
    which the port has none of).  On a ``mesh`` it takes a mesh
    `make_prefill`'s state (the rank's cache, every row's logits) and
    returns the global tokens."""
    c = config
    _validate(c)
    _check_window(c, start_pos, steps, "start_pos")
    sampled = temperature > 0.0
    _validate_filters(c.vocab, sampled, top_k, top_p)
    pick = _make_pick(sampled, temperature, top_k, top_p)
    place = _place(mesh)

    @torch.no_grad()
    def run(params, cache, last_logits, key=None):
        _key_or_raise(sampled, key, "fn(params, cache, last_logits, key)")
        own = {name: ({k: t.clone() for k, t in leaf.items()} if is_quantized_leaf(leaf)
                      else leaf.clone())
               for name, leaf in cache.items()}
        keys = _make_keys(sampled, key, steps, last_logits.device)
        rows = _rows(place, last_logits.shape[0])
        if rows is not None:
            last_logits = rows.group(last_logits)
        toks, last, lps, fin = _token_loop(params, own, last_logits, start_pos, keys, pick, c,
                                           logprobs=with_logprobs, rows=rows)
        out = torch.cat([toks.transpose(0, 1), last[:, None]], dim=1)
        parts = (out,)
        if with_logprobs:
            parts += (lps,)
        if with_health:
            parts += (fin,)
        return parts if len(parts) > 1 else out

    return run


def generate(params, prompt, steps: int, config: BurninConfig, mesh=None,
             temperature: float = 0.0, key=None):
    """One call of `make_generate` (built per call: hold on to its
    function for a serving loop), on one device or on a ``mesh`` as it
    says.  ``params`` may be plain or int8 as they come."""
    fn = make_generate(config, mesh, prompt_len=prompt.shape[1], steps=steps,
                       temperature=temperature)
    return fn(params, prompt, key)
