"""The burn-in LM in PyTorch: config, parameters and the dense forward.

Counterpart of `tpu_dra.parallel.burnin` for one device.  The config,
the parameter tree and the arithmetic are the reference's; what differs
is idiom: tensors instead of pytrees of jax arrays, a `torch.Generator`
instead of a PRNG key, and a Python loop over the stacked layers
instead of ``lax.scan``.

Rounding follows the reference's source point for point, so that the
parity tests can hold the two to bf16 ulps:

- matmuls take bf16 operands, accumulate in f32 and return bf16;
- attention scores leave their matmul in bf16 and are divided by
  sqrt(d_head) in bf16 (the reference's Python scalar is weakly typed,
  so the divisor itself is rounded to bf16 first), then widened to f32
  and masked with -1e30;
- probabilities are rounded to bf16 before the V product;
- LeakyReLU (slope 0.01, rounded to bf16 like the divisor) runs in bf16;
- the residual stream, the norms and the logits' final cast are f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_dra_torch.parallel.device import resolve_device

__all__ = [
    "BurninConfig",
    "bf16_scalar",
    "forward",
    "init_params",
    "rope_apply",
    "rope_tables",
]

_NEG_INF = -1e30


@dataclass(frozen=True)
class BurninConfig:
    """Model + data shape for the burn-in LM — the reference's fields and
    defaults.  The parallelism and MoE fields are kept so that a config
    reads the same in both packages, but this package serves only the
    dense single-device model: setting any of them raises."""

    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    d_ff: int = 512
    n_layers: int = 2
    seq: int = 128
    batch: int = 8
    learning_rate: float = 1e-2
    optimizer: str = "momentum"
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    # Rotary position embeddings (GPT-NeoX split-half): q/k rotated by
    # absolute position, the additive position table skipped.
    rope: bool = False
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    ring_attention: bool = False
    ulysses_attention: bool = False
    flash_attention: bool = False
    moe_experts: int = 0
    moe_capacity: float = 1.25
    moe_aux_weight: float = 1e-2
    pipeline_stages: int = 0
    pipeline_microbatches: int = 4

    def __post_init__(self):
        unserved = [
            name
            for name, on in (
                ("ring_attention", self.ring_attention),
                ("ulysses_attention", self.ulysses_attention),
                ("flash_attention", self.flash_attention),
                ("moe_experts", self.moe_experts > 0),
                ("pipeline_stages", self.pipeline_stages > 0),
            )
            if on
        ]
        if unserved:
            raise ValueError(
                f"{', '.join(unserved)} not ported to tpu_dra_torch yet: "
                "it serves the dense single-device model only"
            )

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def bf16_scalar(x: float) -> float:
    """``x`` rounded to bf16: the value a weakly typed Python scalar takes
    when the reference combines it with a bf16 array."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def init_params(config: BurninConfig, generator: "torch.Generator | None" = None,
                device: "str | torch.device" = "cuda"):
    """The reference's parameter tree — same keys, stacked ``(L, ...)``
    layer leaves, shapes and fan-in scaling, all f32 — drawn from
    ``generator`` (default: a generator on ``device`` seeded with 0).
    The numbers differ from the reference's, which come from jax.random;
    the parity tests load the reference's own weights instead
    (`weights.params_from_numpy`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    c = config

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return w / (fan_in ** 0.5)

    L = c.n_layers
    return {
        "embed": dense((c.vocab, c.d_model), c.d_model),
        "pos": dense((c.seq, c.d_model), c.d_model),
        "layers": {
            "wqkv": dense((L, c.d_model, 3, c.n_heads, c.d_head), c.d_model),
            "wo": dense((L, c.n_heads, c.d_head, c.d_model), c.d_model),
            "w1": dense((L, c.d_model, c.d_ff), c.d_model),
            "w2": dense((L, c.d_ff, c.d_model), c.d_ff),
            "ln1": torch.ones((L, c.d_model), device=dev),
            "ln2": torch.ones((L, c.d_model), device=dev),
        },
        "ln_f": torch.ones((c.d_model,), device=dev),
    }


def _rms_norm(x, scale):
    x = x.float()
    rms = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    return (x / rms) * scale


def rope_tables(positions, d_head: int, *, base: float = 10000.0):
    """RoPE cos/sin tables for integer ``positions`` ((S,) or (..., S)),
    shaped ``(..., S, 1, d_head/2)`` to broadcast over heads."""
    if d_head % 2 != 0:
        raise ValueError(f"rope needs an even d_head, got {d_head}")
    half = d_head // 2
    exps = -torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32, device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope_apply(x, tables):
    """Rotate ``x`` (..., S, H, K) by `rope_tables`; returns x's dtype."""
    cos, sin = tables
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _matmul_bf16(x, w, n_in: int):
    """Contract the last ``n_in`` dims of ``x`` with the first ``n_in``
    of ``w``, both as bf16: the reference's einsums, f32 accumulation,
    bf16 result of shape ``x.shape[:-n_in] + w.shape[n_in:]``."""
    lead = x.shape[:-n_in]
    rows = x.shape[-n_in:].numel()
    out = x.to(torch.bfloat16).reshape(*lead, rows) @ w.to(torch.bfloat16).reshape(rows, -1)
    return out.reshape(*lead, *w.shape[n_in:])


def _attend_dense(q, k, v, mask, d_head: int):
    """The reference's masked dense attention: q (B, S, H, K) against
    k/v (B, T, H, K) under ``mask`` broadcastable to (B, H, S, T).
    Returns (B, S, H, K) bf16."""
    scores = torch.einsum("bshk,bthk->bhst", q, k) / bf16_scalar(d_head ** 0.5)
    scores = torch.where(mask, scores.float(), _NEG_INF)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (probs / probs.sum(-1, keepdim=True)).to(torch.bfloat16)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def _mlp(layer, x):
    """The dense MLP half of a block: pre-norm, w1, LeakyReLU in bf16,
    w2, residual add in f32."""
    h = _rms_norm(x, layer["ln2"]).to(torch.bfloat16)
    h = _matmul_bf16(h, layer["w1"], 1)
    h = torch.where(h > 0, h, bf16_scalar(0.01) * h)
    return x + _matmul_bf16(h, layer["w2"], 1)


def _block(layer, x, *, config: BurninConfig, rope_tab=None):
    """One pre-norm transformer block over the full sequence (the dense
    single-device branch of the reference's ``_block``)."""
    c = config
    h = _rms_norm(x, layer["ln1"]).to(torch.bfloat16)
    qkv = _matmul_bf16(h, layer["wqkv"], 1)  # (B, S, 3, H, K)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if c.rope:
        q = rope_apply(q, rope_tab)
        k = rope_apply(k, rope_tab)
    S = x.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    att = _attend_dense(q, k, v, mask[None, None], c.d_head)
    x = x + _matmul_bf16(att, layer["wo"], 2)
    return _mlp(layer, x)


def _layer(params, i: int):
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def _logits(params, x):
    x = _rms_norm(x, params["ln_f"]).to(torch.bfloat16)
    return (x @ params["embed"].to(torch.bfloat16).T).float()


def forward(params, tokens, config: BurninConfig):
    """Logits (B, S, vocab) f32 for ``tokens`` (B, S) with S == seq, the
    reference's training forward on one device."""
    c = config
    if tokens.shape[1] != c.seq:
        raise ValueError(f"forward takes full sequences of {c.seq} tokens, got {tokens.shape[1]}")
    x = params["embed"][tokens]
    if not c.rope:
        x = x + params["pos"][None, :, :]
    rope_tab = (
        rope_tables(torch.arange(c.seq, device=tokens.device), c.d_head)
        if c.rope
        else None
    )
    for i in range(c.n_layers):
        x = _block(_layer(params, i), x, config=c, rope_tab=rope_tab)
    return _logits(params, x)
