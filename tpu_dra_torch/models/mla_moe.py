"""DeepSeek-V3's block: multi-head latent attention (MLA) and a dropless
top-k expert layer with shared experts, as Moonlight-16B-A3B publishes it
(``model_type`` deepseek_v3, ``q_lora_rank`` null, one expert group, no
multi-token prediction).

The model, layer by layer (d the hidden width, H heads, R the latent
rank, n/r/v the no-rope, rope and value head widths):

- attention: ``h = rmsnorm(x)``; ``q = h @ wq`` split per head into
  ``q_nope`` (n) and ``q_pe`` (r); ``h @ wkv_a`` gives the latent
  ``c_kv`` (R), normalised by ``kv_norm``, and one rope key ``k_pe`` (r)
  shared by the heads.  The rope rotates pairs of interleaved dims
  ``(2i, 2i+1)`` at frequency ``theta ** (-2i / r)``, as DeepSeek-V3's
  inference code does.  ``c_kv @ wkv_b`` expands to each head's
  ``k_nope`` (n) and ``v`` (v); scores are ``(q_nope . k_nope + q_pe .
  k_pe) / sqrt(n + r)``, causal; the heads' outputs go through ``wo``.
- the first ``first_k_dense_replace`` layers: a SwiGLU of width
  ``intermediate_size``; the rest: the expert layer of
  `moe.topk_moe_mlp` (sigmoid scores, the top ``k`` by score plus a
  selection-only bias, weights normalised over the ``k`` and times
  ``routed_scaling_factor``, and ``n_shared_experts`` shared experts as
  one SwiGLU of their summed width).
- ``rmsnorm`` at the end, and logits through an untied ``lm_head``.

Rounding, the port's convention: matrices bf16, every product
accumulating in f32 and storing bf16; the residual stream, the norms,
the rope's rotation, the router and the softmax in f32; the latent cache
bf16 (the normalised ``c_kv`` and the rotated ``k_pe``, rounded once when
written).

Serving (`PagedMlaMoe`, the model's side of `serve.ServeEngine`'s paged
seam): the pool holds one latent leaf ``(L, NB, W, R + r)`` bf16, 576
values a token a layer at Moonlight's widths, where per-head K and V
would take 16 x 256.  An admission's prefill windows run the expanded
form over the prompt's blocks (DeepSeek's inference does the same); a
decode step runs the absorbed form: ``q_lat[h] = q_nope[h] @ W_UK[h]``
(the k half of ``wkv_b``), one contraction over the latent blocks per
layer (`kernels.mla_decode`, K3, on a card; its plain version or a
gather on the CPU), then ``o[h] = o_lat[h] @ W_UV[h]``.  The two forms
are one function in exact arithmetic; in bf16 they round at other
points.  On a card the decode step is captured as CUDA graphs, one a
block half, and replayed (`paged.DecodeGraphs`), as the prefill windows
are.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from tpu_dra_torch.parallel.kernels import mla_decode as k3
from tpu_dra_torch.parallel.moe import swiglu, topk_moe_mlp
from tpu_dra_torch.parallel.paged import DecodeGraphs, PrefillGraphs
from tpu_dra_torch.utils import trace

__all__ = [
    "MlaMoeConfig", "PagedMlaMoe", "forward", "init_params", "param_count",
]

_BF16 = torch.bfloat16
# Where the attention half of a block runs, under a profiler, and where a
# captured expert half replays (eagerly its parts are `moe_mlp`'s ranges).
ATTN_RANGE = "mla.attn"
MOE_RANGE = "moe.layer"
# The seeded ``e_score_correction_bias``'s standard deviation (assumed:
# the published bias is learned): wide enough to move some choices.
BIAS_SCALE = 0.1


@dataclasses.dataclass(frozen=True)
class MlaMoeConfig:
    """The published keys of a DeepSeek-V3 config (Moonlight-16B-A3B's
    values by default)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    q_lora_rank: "int | None" = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.q_lora_rank is not None:
            raise ValueError("a low-rank query (q_lora_rank) is not implemented: Moonlight "
                             "has none")
        if self.n_group != 1 or self.topk_group != 1:
            raise ValueError("group-limited routing (n_group > 1) is not implemented")
        if not self.norm_topk_prob or self.tie_word_embeddings:
            raise ValueError("the block normalises its top-k weights and unties its embeddings")
        if not 0 <= self.first_k_dense_replace <= self.num_hidden_layers:
            raise ValueError("first_k_dense_replace must lie in [0, num_hidden_layers]")
        if self.qk_rope_head_dim % 2:
            raise ValueError("the rope width must be even")

    @classmethod
    def from_dict(cls, d: dict) -> "MlaMoeConfig":
        """The config from a published ``config.json``'s keys (others ignored)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    # What the serving engine reads of any config.
    @property
    def vocab(self) -> int:
        return self.vocab_size

    @property
    def seq(self) -> int:
        return self.max_position_embeddings

    @property
    def n_layers(self) -> int:
        return self.num_hidden_layers

    def paged_model(self, *, slots: int, positions: int, record_routes: bool = False):
        """The serving engine's seam to this model (`PagedMlaMoe`)."""
        return PagedMlaMoe(self, slots=slots, positions=positions, record_routes=record_routes)

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def latent_width(self) -> int:
        """Values a token a layer in the cache: ``c_kv`` and ``k_pe``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.qk_nope_head_dim + self.qk_rope_head_dim)


def _layer_shapes(c: MlaMoeConfig, i: int) -> "list[tuple[str, tuple, int, torch.dtype]]":
    """``(name, shape, fan_in, dtype)`` of layer ``i``'s leaves; fan_in 0
    marks a norm scale (ones), -1 the router's bias."""
    d, H, R = c.hidden_size, c.num_attention_heads, c.kv_lora_rank
    n, r, v = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    out = [
        ("attn_norm", (d,), 0, torch.float32),
        ("wq", (d, H * (n + r)), d, _BF16),
        ("wkv_a", (d, R + r), d, _BF16),
        ("kv_norm", (R,), 0, torch.float32),
        ("wkv_b", (R, H * (n + v)), R, _BF16),
        ("wo", (H * v, d), H * v, _BF16),
        ("ffn_norm", (d,), 0, torch.float32),
    ]
    if i < c.first_k_dense_replace:
        f = c.intermediate_size
        return out + [("w_gate", (d, f), d, _BF16), ("w_up", (d, f), d, _BF16),
                      ("w_down", (f, d), f, _BF16)]
    E, fe = c.n_routed_experts, c.moe_intermediate_size
    fs = fe * c.n_shared_experts
    return out + [
        ("router", (d, E), d, torch.float32), ("bias", (E,), -1, torch.float32),
        ("we_gate", (E, fe, d), d, _BF16), ("we_up", (E, fe, d), d, _BF16),
        ("we_down", (E, d, fe), fe, _BF16),
        ("ws_gate", (d, fs), d, _BF16), ("ws_up", (d, fs), d, _BF16),
        ("ws_down", (fs, d), fs, _BF16),
    ]


def init_params(c: MlaMoeConfig, seed: int, device="cpu") -> dict:
    """Seeded weights on ``device``: ``randn / sqrt(fan_in)`` in each leaf's
    dtype (layer matrices bf16; norms, router and bias f32), norm scales
    ones, the bias ``BIAS_SCALE * randn``.  The tree: ``embed`` (V, d),
    ``lm_head`` (d, V), ``final_norm`` (d,) and ``layers``, one dict a
    layer.  Each leaf draws from a generator of its own, so the tree is
    the same on every device kind's generator for a seed."""
    dev = torch.device(device)
    counter = [0]

    def draw(shape, fan_in, dtype):
        counter[0] += 1
        if fan_in == 0:
            return torch.ones(shape, dtype=dtype, device=dev)
        g = torch.Generator(device=dev).manual_seed(
            (int(seed) * 1_000_003 + 7919 * counter[0]) % (1 << 63))
        t = torch.randn(shape, generator=g, device=dev, dtype=dtype)
        return t.mul_(BIAS_SCALE if fan_in < 0 else fan_in ** -0.5)

    d, V = c.hidden_size, c.vocab_size
    params = {"embed": draw((V, d), 1, _BF16), "lm_head": draw((d, V), d, _BF16),
              "final_norm": draw((d,), 0, torch.float32), "layers": []}
    for i in range(c.num_hidden_layers):
        params["layers"].append({name: draw(shape, fan, dt)
                                 for name, shape, fan, dt in _layer_shapes(c, i)})
    return params


def param_count(c: MlaMoeConfig) -> int:
    """Every parameter (norms, router and bias included)."""
    total = 2 * c.vocab_size * c.hidden_size + c.hidden_size
    for i in range(c.num_hidden_layers):
        total += sum(math.prod(s) for _, s, _, _ in _layer_shapes(c, i))
    return total


# -- the arithmetic -----------------------------------------------------------


def _rms_norm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope_tables(positions, c: MlaMoeConfig):
    """cos and sin f32 ``positions.shape + (r / 2,)`` of the interleaved
    rope.  The base is filled on the device, so a CUDA graph captures it."""
    r = c.qk_rope_head_dim
    exps = -torch.arange(0, r, 2, dtype=torch.float32, device=positions.device) / r
    inv = torch.pow(torch.full((), c.rope_theta, dtype=torch.float32, device=positions.device),
                    exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """Rotate the interleaved pairs of ``x`` (..., r) by tables that
    broadcast against (..., r / 2); f32 result."""
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1).flatten(-2)


def _project(layer, x, c: MlaMoeConfig, cos, sin):
    """The attention half's projections of ``x`` (B, S, d) f32 at the
    positions of ``cos``/``sin`` (B or 1, S, r/2): ``q_nope`` (B, S, H,
    n) and the rotated ``q_pe`` (B, S, H, r), bf16, and the latent (B, S,
    R + r) bf16 the cache holds."""
    B, S, _ = x.shape
    H, R, n = c.num_attention_heads, c.kv_lora_rank, c.qk_nope_head_dim
    h = _rms_norm(x, layer["attn_norm"], c.rms_norm_eps).to(_BF16)
    q = (h @ layer["wq"]).view(B, S, H, -1)
    q_pe = _rope(q[..., n:], cos[:, :, None], sin[:, :, None]).to(_BF16)
    kv = h @ layer["wkv_a"]
    c_kv = _rms_norm(kv[..., :R], layer["kv_norm"], c.rms_norm_eps).to(_BF16)
    k_pe = _rope(kv[..., R:], cos, sin).to(_BF16)
    return q[..., :n], q_pe, torch.cat([c_kv, k_pe], dim=-1)


def _attend_expanded(layer, q_nope, q_pe, lat, mask, c: MlaMoeConfig):
    """The expanded form: the latent ``lat`` (B, T, R + r) through
    ``wkv_b`` to each head's keys and values, masked softmax attention of
    the (B, S) queries under ``mask`` (broadcastable to (B, S, T)).
    Returns (B, S, H * v) bf16, before ``wo``."""
    B, S, H, n = q_nope.shape
    T = lat.shape[1]
    R = c.kv_lora_rank
    kvb = (lat[..., :R] @ layer["wkv_b"]).view(B, T, H, -1)
    k = torch.cat([kvb[..., :n], lat[..., None, R:].expand(B, T, H, -1)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    s = torch.einsum("bshk,bthk->bhst", q, k).float() * c.scale
    s = torch.where(mask[:, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1).to(_BF16)
    o = torch.einsum("bhst,bthv->bshv", p, kvb[..., n:])
    return o.reshape(B, S, -1)


def _mlp_half(layer, x, c: MlaMoeConfig):
    """The MLP half over ``x`` (B, S, d) f32: the dense SwiGLU or the
    expert layer, residual added in f32.  Returns ``(x, topi)``, topi
    (B, S, k) for an expert layer, else None, and the expert counts."""
    B, S, d = x.shape
    h32 = _rms_norm(x, layer["ffn_norm"], c.rms_norm_eps).reshape(B * S, d)
    if "router" not in layer:
        out = swiglu(h32.to(_BF16), layer["w_gate"], layer["w_up"], layer["w_down"]).float()
        return x + out.view(B, S, d), None, None
    out, topi, counts = topk_moe_mlp(layer, h32, k=c.num_experts_per_tok,
                                     scale=c.routed_scaling_factor)
    return x + out.view(B, S, d), topi.view(B, S, -1), counts


def _logits(params, x, c: MlaMoeConfig):
    h = _rms_norm(x, params["final_norm"], c.rms_norm_eps).to(_BF16)
    return (h @ params["lm_head"]).float()


def forward(params, tokens, c: MlaMoeConfig):
    """The whole model over ``tokens`` (B, S) from position 0, no cache:
    the expanded attention, causal.  Returns ``(logits (B, S, V) f32,
    routes (B, S, moe layers, k))``."""
    B, S = tokens.shape
    cos, sin = rope_tables(torch.arange(S, device=tokens.device)[None], c)
    mask = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()[None]
    x = params["embed"][tokens].float()
    routes = []
    for layer in params["layers"]:
        with trace.range(ATTN_RANGE):
            q_nope, q_pe, lat = _project(layer, x, c, cos, sin)
            o = _attend_expanded(layer, q_nope, q_pe, lat, mask, c)
            x = x + (o @ layer["wo"]).float()
        x, topi, _ = _mlp_half(layer, x, c)
        if topi is not None:
            routes.append(topi)
    return _logits(params, x, c), torch.stack(routes, dim=2) if routes else None


def absorbed_weights(layer, c: MlaMoeConfig):
    """``wkv_b``'s halves as the absorbed form uses them: ``uk_t`` (H, n,
    R), which takes ``q_nope`` into the latent, and ``uv`` (H, R, v),
    which takes the attended latent to each head's output."""
    H, R, n = c.num_attention_heads, c.kv_lora_rank, c.qk_nope_head_dim
    w = layer["wkv_b"].view(R, H, -1)
    return w[..., :n].permute(1, 2, 0).contiguous(), w[..., n:].permute(1, 0, 2).contiguous()


def absorbed_dense(q, lat, pos, c: MlaMoeConfig):
    """The absorbed contraction over a gathered context, dense: ``q`` (B,
    H, R + r) bf16 against ``lat`` (B, T, R + r) bf16 at positions
    ``<= pos`` (B,).  Returns ``o_lat`` (B, H, R) f32 (the probabilities
    rounded to bf16 before their product, as K3 does)."""
    R = c.kv_lora_rank
    s = torch.einsum("bhd,btd->bht", q.float(), lat.float()) * c.scale
    valid = torch.arange(lat.shape[1], device=q.device)[None, :] <= pos[:, None].long()
    p = torch.softmax(torch.where(valid[:, None], s, float("-inf")), dim=-1)
    return torch.einsum("bht,btl->bhl", p.to(_BF16).float(), lat[..., :R].float())


# -- serving: the paged engine's seam -----------------------------------------


class PagedMlaMoe:
    """The model's side of `serve.ServeEngine`'s paged seam: its pool, its
    prefill windows (eager, or captured as CUDA graphs), its decode step,
    and the bookkeeping of the experts' assignments.

    ``tally`` (moe layers, E) int64 on the device sums the assignments of
    the tokens the expert layers computed: every decode row (an idle
    slot's too) and the real prompt tokens of the prefill windows (their
    pads left out); `ServeEngine.moe_assignments` reads it.
    With ``record_routes`` the chosen experts of every row's positions
    are kept on the device, (slots, positions, moe layers, k) uint8,
    and a finished request gets a copy of its own (``Request.routes``)."""

    swap_tier = False  # the engine builds no host tier for it
    default_layout = "paged"

    def __init__(self, config: MlaMoeConfig, *, slots: int, positions: int,
                 record_routes: bool):
        self.config = config
        self.slots = slots
        self.positions = positions
        self.record_routes = record_routes
        self.tally = None
        self.routes = None
        self._prefill_routes = None
        self._decode_graphs: "DecodeGraphs | None" = None
        # How the last `decode` ran: "graph" (replayed) or "eager".
        self.decode_path = "eager"

    def refuse(self, *, kv_layout, kv_int8, quantized, prefix_cache_slots, host_kv_blocks,
               tier, mesh, **_engine_options) -> None:
        """What the latent-cache engine does not serve yet, each refused
        with its reason."""
        name = "the latent-attention (DeepSeek-V3) model"
        if kv_layout not in (None, "paged"):
            raise ValueError(f"{name} serves on kv_layout='paged' only: its cache is a latent "
                             "block pool")
        if kv_int8 or quantized:
            raise ValueError(f"{name} serves bf16 only: int8 weights and an int8 latent pool "
                             "are not implemented")
        if prefix_cache_slots:
            raise ValueError(f"{name} has no prefix cache yet: its entries would alias latent "
                             "blocks, which the prefix index does not describe")
        if host_kv_blocks:
            raise ValueError(f"{name} has no swap tier yet (host_kv_blocks must be 0)")
        if tier != "mono":
            raise ValueError(f"{name} serves on a mono engine only: the disaggregated tiers' "
                             "handoff moves per-head K/V blocks")
        if mesh is not None:
            raise ValueError(f"{name} serves on one device: no sharded form yet")

    def check_chunk(self, prompt_slots: int, prefill_chunk: "int | None") -> None:
        """The experts are dropless, so a windowed prefill routes each
        token as a one-shot pass does: only the grid is checked."""
        if prefill_chunk is not None and (prefill_chunk < 1 or prompt_slots % prefill_chunk):
            raise ValueError(f"prefill_chunk must divide prompt_slots, got {prefill_chunk} vs "
                             f"{prompt_slots}")

    def check_window(self, prompt_slots: int, window: int) -> None:
        if not 1 <= window <= prompt_slots or prompt_slots % window:
            raise ValueError(f"prefix window must divide prompt_slots, got {window} vs "
                             f"{prompt_slots}")

    def prepare(self, params) -> dict:
        """The served tree: the params with each layer's absorbed halves
        of ``wkv_b`` added (``uk_t``, ``uv``)."""
        layers = []
        for layer in params["layers"]:
            if layer["wq"].dtype != _BF16:
                raise TypeError("serve bf16 layer matrices (init_params' tree)")
            uk_t, uv = absorbed_weights(layer, self.config)
            layers.append({**layer, "uk_t": uk_t, "uv": uv})
        return {**params, "layers": layers}

    def init_pool(self, num_blocks: int, block_size: int, *, kv_int8: bool, device, mesh):
        """The latent pool ``{"latent": (L, NB, W, R + r)}`` bf16, zeros
        (scratch block 0 is read, masked, by frozen rows), and the
        tallies.  (``kv_int8`` and ``mesh`` are refused before this.)"""
        c = self.config
        if num_blocks < 2:
            raise ValueError(f"block pool needs >= 2 blocks (block 0 is scratch), got {num_blocks}")
        dev = torch.device(device)
        self.tally = torch.zeros((c.n_moe_layers, c.n_routed_experts), dtype=torch.int64,
                                 device=dev)
        if self.record_routes and c.n_moe_layers:
            self.routes = torch.zeros((self.slots, self.positions, c.n_moe_layers,
                                       c.num_experts_per_tok), dtype=torch.uint8, device=dev)
        return {"latent": torch.zeros((c.n_layers, num_blocks, block_size, c.latent_width),
                                      dtype=_BF16, device=dev)}

    # -- prefill -------------------------------------------------------------
    def _window(self, params, prompt, lens, pool, table, last, p0: int, prompt_cols: int):
        """One prefill window at ``p0`` of a (B, P) padded prompt: its
        latents into block column ``p0 // W`` of ``table``, the expanded
        attention over the prompt's blocks, and ``last`` (B, V) takes the
        logits of each row whose last real position falls in it."""
        c = self.config
        lat_pool = pool["latent"]
        W = lat_pool.shape[2]
        B, dev = prompt.shape[0], prompt.device
        positions = p0 + torch.arange(W, device=dev)
        cos, sin = rope_tables(positions[None], c)
        mask = (torch.arange(prompt_cols * W, device=dev)[None, :] <= positions[:, None])[None]
        blk = table[:, p0 // W].long()
        cols = table[:, :prompt_cols].long()
        # The real prompt tokens' assignments count, pads do not.
        real = (positions[None, :] < lens.long()[:, None]).reshape(-1).long()
        real = real.repeat_interleave(c.num_experts_per_tok)
        x = params["embed"][prompt[:, p0:p0 + W].long()].float()
        routes = []
        for i, layer in enumerate(params["layers"]):
            with trace.range(ATTN_RANGE):
                q_nope, q_pe, lat = _project(layer, x, c, cos, sin)
                lat_pool[i].index_put_((blk,), lat)
                ctx = lat_pool[i][cols].reshape(B, prompt_cols * W, -1)
                o = _attend_expanded(layer, q_nope, q_pe, ctx, mask, c)
                x = x + (o @ layer["wo"]).float()
            x, topi, _ = _mlp_half(layer, x, c)
            if topi is not None:
                routes.append(topi)
                self.tally[len(routes) - 1].scatter_add_(0, topi.reshape(-1), real)
        if self._prefill_routes is not None and routes:
            self._prefill_routes[p0:p0 + W] = torch.stack(routes, dim=2)[0].to(torch.uint8)
        off = lens.long() - 1 - p0
        hit = (off >= 0) & (off < W)
        xl = x[torch.arange(B, device=dev), off.clamp(0, W - 1)]
        return torch.where(hit[:, None], _logits(params, xl[:, None], c)[:, 0], last)

    def _prefill_buffers(self, prompt_slots: int, device) -> None:
        c = self.config
        if self.record_routes and c.n_moe_layers and self._prefill_routes is None:
            self._prefill_routes = torch.zeros(
                (prompt_slots, c.n_moe_layers, c.num_experts_per_tok), dtype=torch.uint8,
                device=device)

    def make_prefill(self, prompt_slots: int, block_size: int, mesh=None):
        """The eager prefill: ``prefill(params, prompt, lens, pool, table,
        first_window=0) -> (last, pool)`` over windows ``[first_window,
        prompt_slots / W)`` (`paged.make_paged_prefill`'s contract)."""
        nwin = prompt_slots // block_size

        def prefill(params, prompt, lens, pool, table, first_window=0):
            self._prefill_buffers(prompt_slots, prompt.device)
            last = torch.zeros((prompt.shape[0], self.config.vocab_size), device=prompt.device)
            for i in range(first_window, nwin):
                last = self._window(params, prompt, lens, pool, table, last, i * block_size, nwin)
            return last, pool

        return prefill

    def capture(self, prompt_slots: int, block_size: int, table_cols: int, params, pool):
        """The windows captured as CUDA graphs (`paged.PrefillGraphs`)."""
        self._prefill_buffers(prompt_slots, pool["latent"].device)
        nwin = prompt_slots // block_size

        def window(prompt, lens, table, last, p0):
            return self._window(params, prompt, lens, pool, table, last, p0, nwin)

        return PrefillGraphs(self.config, prompt_slots, block_size, table_cols, params, pool,
                             window_fn=window, device=pool["latent"].device)

    def admitted(self, row: int, length: int) -> None:
        """A row's prefill ran: its prompt's routes into the row's record."""
        if self.routes is not None:
            self.routes[row, :length] = self._prefill_routes[:length]

    def fed_routes(self, row: int, req):
        """A copy of the routes of the positions ``req`` has fed in
        ``row``: the prompt and every generated token but the last, which
        is not fed yet (None without ``record_routes``)."""
        if self.routes is None:
            return None
        return self.routes[row, :len(req.prompt) + len(req.tokens) - 1].clone()

    def finished(self, row: int, req) -> None:
        """A request finished in ``row``: its routes kept on it."""
        req.routes = self.fed_routes(row, req)

    # -- decode --------------------------------------------------------------
    def capture_decode(self, params, pool, tok, table, pos, backend: str) -> None:
        """Nothing captured at build: the first step on a card runs op by
        op over its real inputs and captures the step (`decode`)."""

    def drop_decode_graphs(self) -> None:
        self._decode_graphs = None

    def _decode_parts(self, params, pool, backend: str) -> list:
        """The decode step cut at its block halves, in order: ``(name,
        part)`` pairs, each ``part(st)`` reading and writing the step's
        state ``st`` (the inputs ``tok``, ``table``, ``pos``; the residual
        stream ``x``; ``logits`` at the end).  ``name`` is the range a
        replay of the part's graph runs under (`paged.DecodeGraphs`);
        eagerly the parts open their own ranges."""
        c = self.config
        lat_pool = pool["latent"]
        W = lat_pool.shape[2]
        R = c.kv_lora_rank

        def head(st):
            table, pos = st["table"], st["pos"]
            reach = min(table.shape[1] * W, c.seq)
            over = pos >= reach
            pos = pos.clamp(max=reach - 1)
            table = torch.where(over[:, None], 0, table)
            rows = torch.arange(pos.shape[0], device=pos.device)
            st["cos"], st["sin"] = rope_tables(pos[:, None], c)
            st["blk"] = table[rows, (pos // W).long()].long()
            st["slot"] = (pos % W).long()
            st["rows"], st["pos_c"], st["table_c"] = rows, pos, table
            st["x"] = params["embed"][st["tok"].long()][:, None].float()

        def attn(i, layer):
            def part(st):
                x, table, pos = st["x"], st["table_c"], st["pos_c"]
                B = x.shape[0]
                with trace.range(ATTN_RANGE):
                    q_nope, q_pe, lat = _project(layer, x, c, st["cos"], st["sin"])
                    lat_pool[i].index_put_((st["blk"], st["slot"]), lat[:, 0])
                    q_lat = torch.einsum("bhn,hnl->bhl", q_nope[:, 0], layer["uk_t"])
                    q = torch.cat([q_lat, q_pe[:, 0]], dim=-1).contiguous()
                    if backend == "cuda":
                        o_lat = k3.mla_decode(q, lat_pool[i], table, pos, v_dim=R,
                                              scale=c.scale)
                    else:
                        ctx = lat_pool[i][table.long()].reshape(B, -1, c.latent_width)
                        o_lat = absorbed_dense(q, ctx, pos, c)
                    o = torch.einsum("bhl,hlv->bhv", o_lat.to(_BF16), layer["uv"])
                    st["x"] = x + (o.reshape(B, 1, -1) @ layer["wo"]).float()
            return part

        def mlp(j, layer):
            def part(st):
                st["x"], topi, counts = _mlp_half(layer, st["x"], c)
                if topi is not None:
                    self.tally[j] += counts
                    if self.routes is not None:
                        self.routes[st["rows"], st["pos_c"].long(), j] = topi[:, 0].to(
                            torch.uint8)
            return part

        def tail(st):
            st["logits"] = _logits(params, st["x"], c)[:, 0]

        parts = [(None, head)]
        for i, layer in enumerate(params["layers"]):
            j = i - c.first_k_dense_replace
            parts.append((ATTN_RANGE, attn(i, layer)))
            parts.append((MOE_RANGE if j >= 0 else None, mlp(j, layer)))
        return parts + [(None, tail)]

    def decode(self, params, tok, pool, table, pos, backend: str):
        """One decode step of every row, each at its own position through
        its block table (`paged.paged_decode_step_rows`' contract: a row at
        or past its reach runs at the reach's last position over scratch).
        ``backend`` ``"cuda"``: K3 (its plain version on CPU tensors);
        ``"gather"``: the table's reach gathered and contracted densely.
        On a card with K3 the first step runs op by op and is captured,
        and later steps of the same shapes, params and pool replay it
        (`paged.DecodeGraphs`): the logits are then the graphs' static
        output, valid until the next call; `decode_path` says which ran.
        Returns ``(logits (B, V) f32, pool)``."""
        if backend == "cuda" and tok.device.type == "cuda":
            key = (id(params), pool["latent"].data_ptr(), tok.shape[0], table.shape[1])
            graphs = self._decode_graphs
            if graphs is not None and graphs.key == key:
                self.decode_path = "graph"
                return graphs(tok, table, pos), pool
            self.drop_decode_graphs()  # the old graphs' memory first
            graphs = DecodeGraphs(key, self._decode_parts(params, pool, backend),
                                  functools.partial(k3.note_replays, self.config.n_layers))
            self._decode_graphs = graphs
            self.decode_path = "eager"
            return graphs.capture(tok.clone(), table.clone(), pos.clone()), pool
        self.decode_path = "eager"
        st = {"tok": tok, "table": table, "pos": pos}
        for _, part in self._decode_parts(params, pool, backend):
            part(st)
        return st["logits"], pool
