"""The burn-in LM in PyTorch: config, parameters, forward and training.

Counterpart of `tpu_dra.parallel.burnin` for one device.  The config,
the parameter tree and the arithmetic are the reference's; what differs
is idiom: tensors instead of pytrees of jax arrays, a `torch.Generator`
instead of a PRNG key, a Python loop over the stacked layers instead of
``lax.scan``, `torch.utils.checkpoint` instead of ``jax.checkpoint``,
and an optimizer state updated in place where the reference donates it.

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

import math
import statistics
import time
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.quant import dequantize_bf16

__all__ = [
    "BurninConfig",
    "TrainReport",
    "assemble_train_report",
    "bf16_scalar",
    "forward",
    "init_params",
    "make_train_step",
    "prepare_tokens",
    "rope_apply",
    "rope_tables",
    "sample_tokens",
    "schedule_lr",
    "train",
]

_NEG_INF = -1e30


@dataclass(frozen=True)
class BurninConfig:
    """Model + data shape for the burn-in LM — the reference's fields and
    defaults.  The parallelism and MoE fields are kept so that a config
    reads the same in both packages, but this package runs only the
    single-device model, dense or through the flash kernel: setting any
    of the others raises."""

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
                ("moe_experts", self.moe_experts > 0),
                ("pipeline_stages", self.pipeline_stages > 0),
            )
            if on
        ]
        if unserved:
            raise ValueError(
                f"{', '.join(unserved)} not ported to tpu_dra_torch yet: "
                "it runs the single-device model only"
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
    """One pre-norm transformer block over the full sequence (the
    unsharded branches of the reference's ``_block``: dense attention, or
    the flash kernel when ``flash_attention`` is set)."""
    c = config
    h = _rms_norm(x, layer["ln1"]).to(torch.bfloat16)
    qkv = _matmul_bf16(h, layer["wqkv"], 1)  # (B, S, 3, H, K)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if c.rope:
        q = rope_apply(q, rope_tab)
        k = rope_apply(k, rope_tab)
    if c.flash_attention:
        # The largest power-of-two block <= 128 dividing the sequence; an
        # odd seq would give a degenerate tile, so it is rejected.
        block = math.gcd(128, c.seq)
        if block < 8:
            raise ValueError(f"flash_attention needs seq % 8 == 0, got seq={c.seq}")
        # Imported here: flash imports the kernels, which import this module.
        from tpu_dra_torch.parallel.flash import flash_attention

        att = flash_attention(q, k, v, True, block, block)
    else:
        S = x.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        att = _attend_dense(q, k, v, mask[None, None], c.d_head)
    x = x + _matmul_bf16(att, layer["wo"], 2)
    return _mlp(layer, x)


def _layers(params):
    """The per-layer trees of the stacked leaves, by one ``unbind`` each:
    its backward stacks the layers' gradients once, where indexing would
    add a zero-padded copy of the whole leaf for every layer."""
    names = list(params["layers"])
    per_leaf = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]


def _logits(params, x):
    """Logits f32 of the final norm against the embedding as bf16 (an
    int8 ``{"q","s"}`` table dequantized here, once a call)."""
    x = _rms_norm(x, params["ln_f"]).to(torch.bfloat16)
    return (x @ dequantize_bf16(params["embed"]).to(torch.bfloat16).T).float()


def forward(params, tokens, config: BurninConfig):
    """Logits (B, S, vocab) f32 for ``tokens`` (B, S) with S == seq, the
    reference's training forward on one device.  Where grad is enabled,
    each block runs under `torch.utils.checkpoint` (the reference's
    ``jax.checkpoint``): the backward recomputes a block's activations
    instead of keeping them."""
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
    remat = torch.is_grad_enabled()
    for layer in _layers(params):
        if remat:
            x = checkpoint(_block, layer, x, config=c, rope_tab=rope_tab, use_reentrant=False)
        else:
            x = _block(layer, x, config=c, rope_tab=rope_tab)
    return _logits(params, x)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


def _leaves(tree):
    """The tensors of a nested dict in sorted-key order (the order
    ``jax.tree_util.tree_leaves`` gives a dict)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, sub) for key, sub in tree.items()}
    return fn(tree)


def _loss(params, tokens, config: BurninConfig):
    """Mean next-token cross-entropy, written out as the reference does:
    the max-shifted log-sum-exp minus the picked logit."""
    logits = forward(params, tokens, config)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    zmax = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - zmax), -1)) + zmax[..., 0]
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(lse - picked)


def schedule_lr(config: BurninConfig, t):
    """Learning rate (an f32 0-dim tensor) at step ``t`` (an int or an
    integer tensor): linear warmup over ``warmup_steps`` then, for
    ``lr_schedule="cosine"``, cosine decay to zero at ``total_steps``."""
    c = config
    t = torch.as_tensor(t)
    lr = torch.tensor(c.learning_rate, dtype=torch.float32, device=t.device)
    if c.warmup_steps > 0:
        lr = lr * torch.clamp((t + 1) / c.warmup_steps, max=1.0)
    if c.lr_schedule == "cosine":
        horizon = max(1, c.total_steps - c.warmup_steps)
        frac = torch.clamp((t - c.warmup_steps) / horizon, 0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return lr


def _clip_grads(grads, clip_norm: float):
    """Global-norm clipping, in place: scale the gradient tensors
    ``grads`` (a list) so that their joint L2 norm is at most
    ``clip_norm``; returns the list."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads


def _validate_optim(c: BurninConfig) -> None:
    if c.optimizer not in ("momentum", "adamw"):
        raise ValueError(f'optimizer must be "momentum" or "adamw", got {c.optimizer!r}')
    if c.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f'lr_schedule must be "constant" or "cosine", got {c.lr_schedule!r}')
    if (c.lr_schedule != "constant" or c.warmup_steps > 0) and c.optimizer != "adamw":
        raise ValueError(
            "lr schedules ride the adamw state (its step counter); "
            'momentum is constant-lr by design — set optimizer="adamw"'
        )
    if c.lr_schedule == "cosine" and c.total_steps < 1:
        raise ValueError("cosine schedule needs total_steps >= 1")
    if c.lr_schedule == "cosine" and c.total_steps <= c.warmup_steps:
        raise ValueError(
            f"cosine schedule needs total_steps > warmup_steps "
            f"({c.total_steps} <= {c.warmup_steps}: every post-warmup "
            "step would train at lr=0)"
        )


def _adamw_update(c: BurninConfig, params, opt, grads) -> None:
    """The reference's AdamW, in place: the schedule indexed by the step
    count before the increment, the bias corrections by the count after
    it, decoupled weight decay ``p - lr*(m̂/(sqrt(v̂)+eps) + wd*p)``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m, v = _leaves(opt["m"]), _leaves(opt["v"])
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
    lr = schedule_lr(c, opt["t"])
    opt["t"].add_(1)
    t = opt["t"].float()
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    for p, mp, vp in zip(params, m, v):
        update = (mp / bc1).div_((vp / bc2).sqrt_().add_(eps))
        if c.weight_decay:
            update.add_(p, alpha=c.weight_decay)
        p.sub_(update.mul_(lr))


def make_train_step(config: BurninConfig, device: "str | torch.device" = "cuda"):
    """Build ``(train_step, init_state)`` for one device.

    ``train_step(state, tokens) -> (state, loss)`` takes one optimizer
    step and returns the same ``state`` updated in place (the reference
    donates it) and the loss as a 0-dim tensor; it never waits for the
    device.  ``state`` is ``(params, opt)``: ``opt`` is the momentum tree
    for ``optimizer="momentum"`` (SGD with momentum 0.9 at the constant
    ``learning_rate``), or ``{"m", "v", "t"}`` for ``"adamw"`` (with
    `schedule_lr` and ``weight_decay``).  ``grad_clip_norm`` clips the
    global norm for both.  ``init_state`` comes from `init_params`' seeded
    generator; `weights.state_from_numpy` gives the reference's own."""
    c = config
    _validate_optim(c)
    dev = resolve_device(device)

    def step(state, tokens):
        params, opt = state
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = _loss(params, tokens, c)
            # With rope the additive position table is unused: its
            # gradient is zeros, as the reference's is.
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                             materialize_grads=True))
        with torch.no_grad():
            if c.grad_clip_norm > 0:
                _clip_grads(grads, c.grad_clip_norm)
            if c.optimizer == "adamw":
                _adamw_update(c, leaves, opt, grads)
            else:
                mom = _leaves(opt)
                torch._foreach_mul_(mom, 0.9)
                torch._foreach_add_(mom, grads)
                torch._foreach_add_(leaves, mom, alpha=-c.learning_rate)
        return state, loss.detach()

    return step, _init_state(c, dev)


def _init_state(config: BurninConfig, device: "str | torch.device" = "cuda"):
    params = init_params(config, device=device)
    if config.optimizer == "adamw":
        return params, {
            "m": _tree_map(torch.zeros_like, params),
            "v": _tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=params["ln_f"].device),
        }
    return params, _tree_map(torch.zeros_like, params)


def sample_tokens(config: BurninConfig, generator: "torch.Generator | None" = None,
                  device: "str | torch.device" = "cuda"):
    """Synthetic (batch, seq) int32 tokens with learnable structure: each
    row walks ``(start + 17 t) % vocab``, and 5% of the positions are
    replaced by random tokens.  ``generator`` defaults to one on
    ``device`` seeded with 42; the numbers differ from the reference's
    jax.random ones."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(42)
    c = config
    start = torch.randint(0, c.vocab, (c.batch, 1), generator=generator, device=dev)
    walk = (start + torch.arange(c.seq, device=dev)[None, :] * 17) % c.vocab
    noise = torch.rand((c.batch, c.seq), generator=generator, device=dev) < 0.05
    rand = torch.randint(0, c.vocab, (c.batch, c.seq), generator=generator, device=dev)
    return torch.where(noise, rand, walk).to(torch.int32)


def prepare_tokens(config: BurninConfig, device: "str | torch.device" = "cuda"):
    """The synthetic batch on ``device`` (the single-device form of the
    reference's, which also places it on a mesh)."""
    return sample_tokens(config, device=device)


@dataclass
class TrainReport:
    """Outcome of a burn-in training run."""

    ok: bool
    steps: int
    loss_first: float
    loss_last: float
    step_seconds_p50: float
    tokens_per_second: float
    error: str = ""


def train(config: "BurninConfig | None" = None, steps: int = 10,
          device: "str | torch.device" = "cuda") -> TrainReport:
    """Run the burn-in on one device: ``max(2, steps)`` steps on the
    synthetic batch from `init_params`' seeded weights, the loss fetched
    once a step.  Reports, never raises: a failure comes back as
    ``TrainReport(ok=False, error=...)``."""
    c = config or BurninConfig()
    try:
        step_fn, state = make_train_step(c, device)
        tokens = prepare_tokens(c, device)
        losses, times = [], []
        for _ in range(max(2, steps)):
            t0 = time.perf_counter()
            state, loss = step_fn(state, tokens)
            loss = float(loss)  # waits for the step
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        return assemble_train_report(c, losses, times)
    except Exception as e:  # burn-in reports, never crashes its caller
        return TrainReport(
            ok=False, steps=0, loss_first=0.0, loss_last=0.0,
            step_seconds_p50=0.0, tokens_per_second=0.0, error=f"{type(e).__name__}: {e}",
        )


def assemble_train_report(c: BurninConfig, losses: "list[float]",
                          times: "list[float]") -> TrainReport:
    """Loss descent and a NaN check make ``ok``; the median step time
    drops the first step (warm-up: kernel builds, allocator growth)."""
    p50 = statistics.median(times[1:])
    return TrainReport(
        ok=losses[-1] < losses[0] and all(l == l for l in losses),  # NaN check
        steps=len(losses),
        loss_first=losses[0],
        loss_last=losses[-1],
        step_seconds_p50=p50,
        tokens_per_second=c.batch * c.seq / p50 if p50 > 0 else 0.0,
    )
