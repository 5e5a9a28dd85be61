"""The burn-in LM in PyTorch: config, parameters, forward and training.

Counterpart of `tpu_dra.parallel.burnin`, on one device or sharded over
a `DeviceMesh` of ranks.  The config, the parameter tree and the
arithmetic are the reference's; what differs is idiom: tensors instead
of pytrees of jax arrays, a `torch.Generator` instead of a PRNG key, a
Python loop over the stacked layers instead of ``lax.scan``,
`torch.utils.checkpoint` instead of ``jax.checkpoint``, and an optimizer
state updated in place where the reference donates it.

On a mesh (``data``, ``fsdp``, ``model`` and optionally ``expert``, one
process a rank) each rank holds its shards of the state (`param_specs`)
and its batch rows, and the collectives the reference's sharding
constraints make XLA insert are explicit (`spmd`):

- dp: the batch over ``data`` x ``fsdp``; gradients summed over every
  axis a leaf is replicated on after the backward (`spmd.reduce_grads`);
- fsdp (ZeRO-3): every matrix's non-tp dim over ``fsdp``, all-gathered
  at its use inside the block, its gradient reduce-scattered back;
- tp (Megatron): heads and the MLP hidden dim over ``model``, the
  column-parallel product local, the row-parallel one a partial sum;
- sp: the residual stream sharded over the sequence on ``model``; the
  norms run on the shard, an all-gather of the sequence enters the tp
  region (its backward a reduce-scatter) and a reduce-scatter of the
  row-parallel partial sums leaves it (its backward an all-gather);
- cp (``ring_attention`` or ``ulysses_attention``): the sequence stays
  sharded through the whole block, attention by
  `ring.ring_attention_sharded` or `ulysses.ulysses_attention_sharded`
  (the flash kernel on the head-swapped view with ``flash_attention``),
  weights replicated over ``model``;
- ep (``moe_experts``): experts over ``expert`` (each expert's FFN over
  ``model``) or, without that axis, over ``model`` (`moe.moe_mlp_sharded`);
  under cp, on a mesh with an ``expert`` axis only, group-local routing,
  one group a rank's sequence block (`moe.moe_mlp_local_sharded`);
- pp (``pipeline_stages``, on a (data, pipe, model) mesh): every layer
  leaf's stacked dim over ``pipe``, each stage's blocks the tp/sp/ep
  blocks above, run by `pipeline`'s GPipe schedule; the embedding,
  position table and final norm whole on every rank.

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

With ``moe_experts > 0`` each block's MLP is the switch-routed expert MLP
(`moe.moe_mlp`) and the loss adds ``moe_aux_weight`` times the blocks'
summed load-balance term.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from tpu_dra_torch.parallel import pipeline, prng, spmd
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.mesh import logical_mesh
from tpu_dra_torch.parallel.moe import (
    moe_mlp,
    moe_mlp_local_sharded,
    moe_mlp_sharded,
    moe_param_specs,
)
from tpu_dra_torch.parallel.quant import dequantize_bf16
from tpu_dra_torch.parallel.ring import ring_attention_sharded
from tpu_dra_torch.parallel.spmd import mesh_sizes
from tpu_dra_torch.parallel.ulysses import ulysses_attention_sharded
from tpu_dra_torch.utils import trace
from tpu_dra_torch.utils.metrics import TRAIN_PHASE_DEVICE_SECONDS

__all__ = [
    "BurninConfig",
    "TrainReport",
    "assemble_train_report",
    "bf16_scalar",
    "burnin_mesh",
    "forward",
    "init_params",
    "make_train_step",
    "param_specs",
    "prepare_tokens",
    "rope_apply",
    "rope_tables",
    "sample_tokens",
    "schedule_lr",
    "state_shardings",
    "token_spec",
    "train",
]

_NEG_INF = -1e30


@dataclass(frozen=True)
class BurninConfig:
    """Model + data shape for the burn-in LM — the reference's fields and
    defaults.  ``ring_attention`` and ``ulysses_attention`` (context
    parallelism over a mesh's ``model`` axis) run on a mesh only, and
    ``pipeline_stages`` on a (data, pipe, model) mesh only
    (`pipeline.pipeline_mesh`), each refused elsewhere with the
    reference's message."""

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

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    def paged_model(self, *, slots: int, positions: int, record_routes: bool = False):
        """The serving engine's seam to this model (`paged.PagedLM`)."""
        from tpu_dra_torch.parallel.paged import PagedLM

        return PagedLM(self, record_routes=record_routes)

    @property
    def context_parallel(self) -> bool:
        """Either cp flavor: the sequence stays sharded through the whole
        block (attention by the ring or Ulysses, the MLP position-wise)."""
        return self.ring_attention or self.ulysses_attention

    def scaled_to(self, mesh) -> "BurninConfig":
        """The reference's sizes grown minimally so that every sharded dim
        divides its mesh axis (``mesh``: a `DeviceMesh` or ``{axis:
        size}``; absent axes count as 1).  With ``pipeline_stages`` the
        mesh must have a ``pipe`` axis: the batch splits into ``data`` x
        microbatches, the layers into the stages, and ``pipeline_stages``
        becomes the pipe size."""
        shape = mesh_sizes(mesh)
        if self.pipeline_stages > 0 and "pipe" not in shape:
            raise ValueError(
                "pipeline_stages requires a (data, pipe, model) mesh "
                "(tpu_dra_torch.parallel.pipeline.pipeline_mesh), got axes "
                f"{tuple(shape)}"
            )
        fsdp = shape.get("fsdp", 1)
        model = shape.get("model", 1)
        pipe = shape.get("pipe", 1)
        data = shape.get("data", 1) * fsdp
        if self.context_parallel:
            # cp shards the batch over every non-model axis.
            data *= shape.get("expert", 1)
        batch = _round_up(self.batch, data)
        if self.pipeline_stages > 0:
            batch = _round_up(batch, data * self.pipeline_microbatches)
        n_heads = _round_up(self.n_heads, model)
        experts = (
            _round_up(self.moe_experts, shape.get("expert", model)) if self.moe_experts else 0
        )
        return dataclasses.replace(
            self, batch=batch, n_heads=n_heads,
            d_model=_round_up(self.d_model, n_heads * max(fsdp, 1)),
            d_ff=_round_up(self.d_ff, model * fsdp), seq=_round_up(self.seq, model),
            vocab=_round_up(self.vocab, fsdp * model), moe_experts=experts,
            n_layers=_round_up(self.n_layers, pipe) if self.pipeline_stages else self.n_layers,
            pipeline_stages=pipe if self.pipeline_stages else 0,
        )


def _round_up(v: int, m: int) -> int:
    return v if m <= 1 else ((v + m - 1) // m) * m


def _pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while p * 2 <= min(n, cap) and n % (p * 2) == 0:
        p *= 2
    return p


def burnin_mesh(ranks=None):
    """The (data, fsdp, model) mesh over ``ranks`` (default: every rank of
    the process group) with every axis non-trivial when the count allows:
    ``model`` the largest power of two up to 2 dividing it, ``fsdp`` the
    same of what is left, ``data`` the rest — so that a burn-in step moves
    the tp, sp and ZeRO-3 collectives, not only the gradient all-reduce.
    ``model`` is innermost (the nearest ranks carry the per-layer
    collectives)."""
    if ranks is None:
        ranks = range(dist.get_world_size()) if dist.is_initialized() else [0]
    ranks = list(ranks)
    n = len(ranks)
    model = _pow2_divisor(n, cap=2)
    fsdp = _pow2_divisor(n // model, cap=2)
    return logical_mesh(ranks, data=-1, fsdp=fsdp, model=model)


def param_specs(config: BurninConfig, mesh=None):
    """The reference's parameter layout as the port's specs (a tuple a
    leaf, an axis name or None a dim; ``mesh`` a `DeviceMesh` or ``{axis:
    size}``): fsdp shards the non-tp dim of every matrix, ``model`` (tp)
    the heads, the MLP hidden dim and the embedding's d_model.  Experts
    ride the mesh's ``expert`` axis when it has one (ep x tp), else
    ``model``.  Under context parallelism the model axis carries the
    sequence, so no weight is sharded over it and fsdp alone shards them.
    With pipeline stages every layer leaf's stacked dim rides ``pipe``
    (a stage holds its own layers), the tp dims ``model`` as above, the
    experts ``model``, and the embedding, position table and final norm
    are whole."""
    if config.pipeline_stages > 0:
        if config.moe_experts > 0:
            mlp = {"router": ("pipe", None, None), "w1e": ("pipe", "model", None, None),
                   "w2e": ("pipe", "model", None, None)}
        else:
            mlp = {"w1": ("pipe", None, "model"), "w2": ("pipe", "model", None)}
        return {
            "embed": (None, None),
            "pos": (None, None),
            "layers": {"wqkv": ("pipe", None, None, "model", None),
                       "wo": ("pipe", "model", None, None), **mlp,
                       "ln1": ("pipe", None), "ln2": ("pipe", None)},
            "ln_f": (None,),
        }
    if config.context_parallel:
        matrices = {
            "wqkv": (None, "fsdp", None, None, None),
            "wo": (None, None, None, "fsdp"),
            "w1": (None, "fsdp", None),
            "w2": (None, None, "fsdp"),
        }
    else:
        matrices = {
            "wqkv": (None, "fsdp", None, "model", None),
            "wo": (None, "model", None, "fsdp"),
            "w1": (None, "fsdp", "model"),
            "w2": (None, "model", "fsdp"),
        }
    if config.moe_experts > 0:
        del matrices["w1"], matrices["w2"]
        expert_axis = "expert" if mesh is not None and "expert" in mesh_sizes(mesh) else "model"
        matrices.update(moe_param_specs(expert_axis, ring=config.context_parallel))
    cp = config.context_parallel
    return {
        "embed": ("fsdp", None) if cp else ("fsdp", "model"),
        "pos": (None, None) if cp else (None, "model"),
        "layers": {**matrices, "ln1": (None, None), "ln2": (None, None)},
        "ln_f": (None,),
    }


def token_spec(config: BurninConfig):
    """The token batch's spec: rows over ``("data", "fsdp")``, or over
    ``"data"`` when pipelined (the pipe mesh has no fsdp axis)."""
    if config.pipeline_stages > 0:
        return ("data", None)
    return (("data", "fsdp"), None)


def state_shardings(config: BurninConfig, mesh=None):
    """The training state's layout, ``(params, opt)`` of specs: the
    momentum (or AdamW's ``m`` and ``v``) laid out as the params, AdamW's
    step counter replicated (``()``).  With `spmd.local_slices` it gives
    the dims and slices of every leaf a rank holds (`weights.shard_state`
    cuts the reference's state by it, `_init_state` the port's)."""
    one = param_specs(config, mesh)
    if config.optimizer == "adamw":
        return one, {"m": one, "v": one, "t": ()}
    return one, one


def bf16_scalar(x: float) -> float:
    """``x`` rounded to bf16: the value a weakly typed Python scalar takes
    when the reference combines it with a bf16 array."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def init_params(config: BurninConfig, generator: "torch.Generator | None" = None,
                device: "str | torch.device" = "cuda"):
    """The reference's parameter tree — same keys, stacked ``(L, ...)``
    layer leaves, shapes and fan-in scaling, all f32; with experts,
    ``router (L, d, E)``, ``w1e (L, E, d, f)`` and ``w2e (L, E, f, d)``
    in place of ``w1``/``w2`` — drawn from
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

    L, D, F, E = c.n_layers, c.d_model, c.d_ff, c.moe_experts
    embed = dense((c.vocab, D), D)
    pos = dense((c.seq, D), D)
    wqkv = dense((L, D, 3, c.n_heads, c.d_head), D)
    wo = dense((L, c.n_heads, c.d_head, D), D)
    if E > 0:
        mlp = {"router": dense((L, D, E), D), "w1e": dense((L, E, D, F), D),
               "w2e": dense((L, E, F, D), F)}
    else:
        mlp = {"w1": dense((L, D, F), D), "w2": dense((L, F, D), F)}
    return {
        "embed": embed,
        "pos": pos,
        "layers": {
            "wqkv": wqkv,
            "wo": wo,
            **mlp,
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
    # The base filled on the device, not copied from the host: a CUDA
    # graph (the paged prefill's) can capture a fill, not that copy.
    freqs = torch.pow(torch.full((), base, dtype=torch.float32, device=positions.device), exps)
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


def _mlp(layer, x, config: BurninConfig, capacity: "int | None" = None):
    """The MLP half of a block: pre-norm, then the dense MLP (w1,
    LeakyReLU in bf16, w2) or the expert MLP (`moe.moe_mlp`, its queues
    ``capacity`` long when given), residual add in f32.  Returns ``(x,
    aux)``, ``aux`` the load-balance term (None for the dense MLP)."""
    h = _rms_norm(x, layer["ln2"]).to(torch.bfloat16)
    if config.moe_experts > 0:
        h, aux = moe_mlp(layer, h, config, capacity)
        return x + h, aux
    h = _matmul_bf16(h, layer["w1"], 1)
    h = torch.where(h > 0, h, bf16_scalar(0.01) * h)
    return x + _matmul_bf16(h, layer["w2"], 1), None


def _block(layer, x, *, config: BurninConfig, rope_tab=None):
    """One pre-norm transformer block over the full sequence (the
    unsharded branches of the reference's ``_block``: dense attention, or
    the flash kernel when ``flash_attention`` is set; the dense or the
    expert MLP).  Returns ``(x, aux)`` as `_mlp` does."""
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
    return _mlp(layer, x, c)


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


def _check_parallelism(c: BurninConfig, mesh) -> None:
    """The reference's refusals in ``forward`` (burnin.py:547-600), with
    its messages (a module path naming the port's)."""
    if c.ring_attention and c.ulysses_attention:
        raise ValueError(
            "ring_attention and ulysses_attention are two flavors of the "
            "same context parallelism; pick one"
        )
    if c.rope and c.context_parallel:
        raise ValueError(
            "rope is not supported with context parallelism: each "
            "sequence shard would need its global position offset wired "
            "through the ring/a2a paths"
        )
    if c.ring_attention and c.flash_attention:
        raise ValueError(
            "ring_attention and flash_attention are mutually exclusive "
            "(the ring shards the sequence over the model axis; flash "
            "tiles the full sequence per tp shard).  ulysses_attention "
            "DOES compose with flash (the kernel runs on the head-sharded "
            "full-sequence view)"
        )
    if c.context_parallel and c.moe_experts > 0 and (
            mesh is None or "expert" not in mesh_sizes(mesh)):
        raise ValueError(
            "context parallelism + moe_experts needs a mesh with a "
            "dedicated expert axis (tpu_dra.parallel.moe.moe_mesh): cp "
            "shards the sequence over the model axis, so experts cannot "
            "ride it"
        )
    if c.pipeline_stages > 0:
        if c.context_parallel or c.flash_attention:
            raise ValueError(
                "pipeline_stages is not combined with ring/flash attention: "
                "the ring rotates K/V over the model axis, which inside the "
                "pipeline's partial-manual shard_map is an auto axis (no "
                "ppermute), and the pallas flash kernel is not validated "
                "under a shard_map body with auto axes"
            )
        if mesh is None or "pipe" not in mesh_sizes(mesh):
            raise ValueError(
                "pipeline_stages requires a (data, pipe, model) mesh "
                "(tpu_dra_torch.parallel.pipeline.pipeline_mesh)"
            )
    if mesh is None and c.context_parallel:
        # A silent dense fallback would report the long-context
        # configuration as trained without running the ring or the swaps.
        raise ValueError("context-parallel attention requires a device mesh")


def forward(params, tokens, config: BurninConfig, mesh=None, *, return_aux: bool = False):
    """Logits f32 for ``tokens`` of full sequences (S == seq), the
    reference's training forward; with ``return_aux``, ``(logits, aux)``,
    ``aux`` the blocks' summed load-balance term (a 0-dim f32 tensor,
    zero without experts).  Where grad is enabled, each block runs under
    `torch.utils.checkpoint` (the reference's ``jax.checkpoint``): the
    backward recomputes a block's activations instead of keeping them.

    On one device (``mesh=None``) ``tokens`` is (B, S) and the logits
    (B, S, vocab).  On a `DeviceMesh` the arguments are this rank's:
    params its shards (`param_specs`), ``tokens`` its batch rows
    (`prepare_tokens`), and the logits its block of the global ones,
    (B / (data x fsdp), S / model, vocab), the sequence block being the
    rank's place on ``model``.  With ``pipeline_stages`` the blocks run
    `pipeline.forward_pipelined`'s GPipe schedule (the batch over
    ``data`` only)."""
    c = config
    if tokens.shape[1] != c.seq:
        raise ValueError(f"forward takes full sequences of {c.seq} tokens, got {tokens.shape[1]}")
    _check_parallelism(c, mesh)
    if c.pipeline_stages > 0:
        logits, aux = pipeline.forward_pipelined(params, tokens, c, mesh)
        return (logits, aux) if return_aux else logits
    if mesh is not None:
        return _forward_sharded(params, tokens, c, spmd.Place(mesh), return_aux)
    x = params["embed"][tokens]
    if not c.rope:
        x = x + params["pos"][None, :, :]
    rope_tab = (
        rope_tables(torch.arange(c.seq, device=tokens.device), c.d_head)
        if c.rope
        else None
    )
    remat = torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _layers(params):
        if remat:
            x, aux_l = checkpoint(_block, layer, x, config=c, rope_tab=rope_tab,
                                  use_reentrant=False)
        else:
            x, aux_l = _block(layer, x, config=c, rope_tab=rope_tab)
        if aux_l is not None:
            aux = aux + aux_l
    logits = _logits(params, x)
    return (logits, aux) if return_aux else logits


def _seq_block(place: "spmd.Place", seq: int) -> "tuple[int, int]":
    """(first position, length) of the rank's block of the sequence on
    ``model`` (sp and cp)."""
    n = seq // place.size("model")
    return place.index("model") * n, n


def _block_sharded(layer, x, *, config: BurninConfig, place: "spmd.Place", specs,
                   rope_tab=None):
    """One pre-norm block on the rank's shards: ``x`` (B_local,
    S / model, d) f32, its block of the residual stream, ``layer`` its
    shards of one layer's leaves, ``specs`` their layouts.  Each matrix
    is all-gathered over ``fsdp`` as bf16 at its use.  Returns ``(x,
    aux)`` as `_block` does, ``x`` the same block."""
    c = config
    bf16 = torch.bfloat16

    def weight(name):
        return spmd.gather_leaf(layer[name], specs[name], place, dtype=bf16)

    h = _rms_norm(x, layer["ln1"]).to(bf16)
    if c.context_parallel:
        # cp: the sequence stays sharded; all heads here.  The ring
        # rotates K/V; Ulysses swaps to the rank's heads over the whole
        # sequence and back.
        qkv = _matmul_bf16(h, weight("wqkv"), 1)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if c.ulysses_attention:
            block = math.gcd(128, c.seq)
            if c.flash_attention and block < 8:
                raise ValueError(f"flash_attention needs seq % 8 == 0, got seq={c.seq}")
            att = ulysses_attention_sharded(q, k, v, place.mesh, "model", causal=True,
                                            flash=c.flash_attention, flash_block=block,
                                            seq=c.seq)
        else:
            att = ring_attention_sharded(q, k, v, place.mesh, "model", causal=True)
        x = x + _matmul_bf16(att, weight("wo"), 2)
    else:
        # sp -> tp: the whole sequence, this rank's heads (the
        # column-parallel product's own output, so q, k and v keep the
        # contiguous head and feature dims the flash kernel needs).
        h = spmd.gather(h, place, "model", 1)
        qkv = _matmul_bf16(h, weight("wqkv"), 1)  # (B, S, 3, H / model, K)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if c.rope:
            q = rope_apply(q, rope_tab)
            k = rope_apply(k, rope_tab)
        if c.flash_attention:
            block = math.gcd(128, c.seq)
            if block < 8:
                raise ValueError(f"flash_attention needs seq % 8 == 0, got seq={c.seq}")
            from tpu_dra_torch.parallel.flash import flash_attention_sharded

            att = flash_attention_sharded(q, k, v, place.mesh, "model", block_q=block,
                                          block_k=block)
        else:
            S = h.shape[1]
            mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
            att = _attend_dense(q, k, v, mask[None, None], c.d_head)
        # Row-parallel out: each rank's heads give a partial sum, summed
        # and split back over the sequence (tp -> sp).
        x = x + spmd.scatter(_matmul_bf16(att, weight("wo"), 2), place, "model", 1)

    h = _rms_norm(x, layer["ln2"]).to(bf16)
    if c.moe_experts > 0 and c.context_parallel:
        # cp x ep: group-local routing, the rank's sequence block its group.
        out, aux = moe_mlp_local_sharded(layer, h, c, place, specs)
        return x + out, aux
    if c.moe_experts > 0:
        out, aux = moe_mlp_sharded(layer, spmd.gather(h, place, "model", 1), c, place, specs)
        return x + out, aux
    if not c.context_parallel:
        h = spmd.gather(h, place, "model", 1)
    h = _matmul_bf16(h, weight("w1"), 1)
    h = torch.where(h > 0, h, bf16_scalar(0.01) * h)
    h = _matmul_bf16(h, weight("w2"), 1)
    if not c.context_parallel:  # cp's MLP is position-wise: no partial sums
        h = spmd.scatter(h, place, "model", 1)
    return x + h, None


def _forward_sharded(params, tokens, c: BurninConfig, place: "spmd.Place", return_aux: bool):
    specs = param_specs(c, place.sizes)
    lo, n = _seq_block(place, c.seq)
    # The embedding is (vocab / fsdp, d / model) a rank: the lookup and
    # the tied logits product take the whole table, and its gradient is
    # reduce-scattered back to the shard.
    embed = spmd.gather_leaf(params["embed"], specs["embed"], place, axes=("fsdp", "model"))
    x = embed[tokens[:, lo:lo + n]]
    if not c.rope:
        pos = spmd.gather_leaf(params["pos"], specs["pos"], place, axes=("model",))
        x = x + pos[None, lo:lo + n]
    rope_tab = (
        rope_tables(torch.arange(c.seq, device=tokens.device), c.d_head) if c.rope else None
    )
    layer_specs = {name: spec[1:] for name, spec in specs["layers"].items()}
    if c.pipeline_stages > 0:
        x, aux = pipeline.pipelined_blocks(params["layers"], x, c, place, layer_specs, rope_tab)
    else:
        remat = torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in _layers(params):
            kw = dict(config=c, place=place, specs=layer_specs, rope_tab=rope_tab)
            if remat:
                x, aux_l = checkpoint(_block_sharded, layer, x, use_reentrant=False, **kw)
            else:
                x, aux_l = _block_sharded(layer, x, **kw)
            if aux_l is not None:
                aux = aux + aux_l
    x = _rms_norm(x, params["ln_f"]).to(torch.bfloat16)
    logits = (x @ embed.to(torch.bfloat16).T).float()
    return (logits, aux) if return_aux else logits


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


def _loss(params, tokens, config: BurninConfig, mesh=None):
    """Mean next-token cross-entropy, written out as the reference does:
    the max-shifted log-sum-exp minus the picked logit; with experts, plus
    ``moe_aux_weight`` times the load-balance term.  On a mesh, this
    rank's share of it (`_loss_sharded`)."""
    if mesh is not None:
        return _loss_sharded(params, tokens, config, spmd.Place(mesh))
    logits, aux = forward(params, tokens, config, return_aux=True)
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    zmax = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - zmax), -1)) + zmax[..., 0]
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = torch.mean(lse - picked)
    if config.moe_experts > 0:
        ce = ce + config.moe_aux_weight * aux
    return ce


def _loss_sharded(params, tokens, config: BurninConfig, place: "spmd.Place"):
    """This rank's share of the loss; the shares of every rank sum to it.

    The rank scores its block of positions: a position's target is the
    next token, which the rank holds (its rows are whole), and only the
    sequence's last position, on the last ``model`` block, has none.  The
    mean is over the global B x (S - 1) targets.  On a mesh with an
    ``expert`` axis the token rows repeat over it, so each of those ranks
    counts 1/expert of its sum; the load-balance term is the same number
    on every rank (global means), so each counts 1/world of it.  Pipelined,
    the rows repeat over ``pipe`` (each pipe rank counts 1/pipe) and are
    scored in the order the schedule computes them
    (`pipeline.microbatch_rows`)."""
    c = config
    _check_parallelism(c, place.sizes)
    if c.pipeline_stages > 0:
        pipeline.check_config(c, place)
        tokens = pipeline.microbatch_rows(tokens, c, place)
    logits, aux = _forward_sharded(params, tokens, c, place, True)
    lo, n = _seq_block(place, c.seq)
    n = min(n, c.seq - 1 - lo)
    logits = logits[:, :n]
    targets = tokens[:, lo + 1:lo + 1 + n].long()
    zmax = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - zmax), -1)) + zmax[..., 0]
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    repeat = place.world // (place.size("data") * place.size("fsdp") * place.size("model"))
    ce = torch.sum(lse - picked) / (c.batch * (c.seq - 1) * repeat)
    if c.moe_experts > 0:
        ce = ce + c.moe_aux_weight * aux / place.world
    return ce


def _total(x, place: "spmd.Place"):
    """The sum of ``x`` over every rank of the mesh (no gradient)."""
    x = x.detach().clone()
    for axis in place.sizes:
        if place.size(axis) > 1:
            dist.all_reduce(x, group=place.group(axis))
    return x


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


def _clip_grads(grads, clip_norm: float, specs=None, place: "spmd.Place | None" = None):
    """Global-norm clipping, in place: scale the gradient tensors
    ``grads`` (a list) so that their joint L2 norm is at most
    ``clip_norm``; returns the list.  On a mesh (``specs`` the leaves'
    layouts, ``place`` the rank's) the norm is the global gradient's: a
    shard repeated over k ranks counts 1/k on each, summed over them all."""
    if place is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    else:
        sq = sum(
            torch.sum(torch.square(g.float()))
            * (math.prod(place.size(a) for a in spmd.spec_axes(spec)) / place.world)
            for g, spec in zip(grads, specs)
        )
        gnorm = torch.sqrt(_total(sq, place))
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


def _apply_update(c: BurninConfig, leaves, opt, grads) -> None:
    """The optimizer step on ``leaves`` in place: SGD with momentum 0.9 at
    the constant ``learning_rate``, or `_adamw_update`."""
    if c.optimizer == "adamw":
        _adamw_update(c, leaves, opt, grads)
    else:
        mom = _leaves(opt)
        torch._foreach_mul_(mom, 0.9)
        torch._foreach_add_(mom, grads)
        torch._foreach_add_(leaves, mom, alpha=-c.learning_rate)


def _placement(mesh, device):
    """``(mesh, device)`` from the reference's ``mesh`` argument, which
    may also be a device (the single-device form's positional device)."""
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh, device
    return None, mesh


def make_train_step(config: BurninConfig, mesh=None, *, device: "str | torch.device" = "cuda",
                    with_state: bool = True):
    """Build ``(train_step, init_state)`` (``init_state`` None with
    ``with_state=False``: a caller about to restore a state never holds a
    fresh one beside it), on one ``device`` or over a `DeviceMesh`
    (``mesh`` may also be the device, the single-device form).

    ``train_step(state, tokens) -> (state, loss)`` takes one optimizer
    step and returns the same ``state`` updated in place (the reference
    donates it) and the loss as a 0-dim tensor; it never waits for the
    device.  ``state`` is ``(params, opt)``: ``opt`` is the momentum tree
    for ``optimizer="momentum"`` (SGD with momentum 0.9 at the constant
    ``learning_rate``), or ``{"m", "v", "t"}`` for ``"adamw"`` (with
    `schedule_lr` and ``weight_decay``).  ``grad_clip_norm`` clips the
    global norm for both.  ``init_state`` comes from `init_params`' seeded
    generator; `weights.state_from_numpy` gives the reference's own.

    On a mesh every rank calls the step with its shards of the state
    (`state_shardings`; `weights.shard_state` cuts the reference's) and
    its batch rows (`prepare_tokens`); the loss is the global one on every
    rank.  ``config`` must fit the mesh (`BurninConfig.scaled_to`).

    Every step's phases, forward (the loss), backward (the gradients; on
    a mesh, reduced over it) and update (clip and optimizer), are the
    ranges ``train.forward``, ``train.backward`` and ``train.update``
    under a profiler, and their device-clock times are observed into
    ``tpu_dra_train_phase_device_seconds`` (`_PhaseClock`)."""
    c = config
    _validate_optim(c)
    mesh, device = _placement(mesh, device)
    if mesh is not None:
        place = spmd.Place(mesh)
        return _sharded_step(c, place), (_init_state(c, place.device, place) if with_state
                                         else None)
    dev = resolve_device(device)
    clock = _PhaseClock(dev)

    def step(state, tokens):
        params, opt = state
        clock.start()
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            with trace.range("train.forward"):
                loss = _loss(params, tokens, c)
            clock.mark(1)
            with trace.range("train.backward"):
                # With rope the additive position table is unused: its
                # gradient is zeros, as the reference's is.
                grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                                 materialize_grads=True))
            clock.mark(2)
        with torch.no_grad(), trace.range("train.update"):
            if c.grad_clip_norm > 0:
                _clip_grads(grads, c.grad_clip_norm)
            _apply_update(c, leaves, opt, grads)
        clock.end()
        return state, loss.detach()

    return step, (_init_state(c, dev) if with_state else None)


def _sharded_step(c: BurninConfig, place: "spmd.Place"):
    specs = _leaves(param_specs(c, place.sizes))
    clock = _PhaseClock(place.device)

    def step(state, tokens):
        params, opt = state
        clock.start()
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            with trace.range("train.forward"):
                loss = _loss_sharded(params, tokens, c, place)
            clock.mark(1)
            with trace.range("train.backward"):
                grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                                 materialize_grads=True))
                # A leaf replicated over an axis (every leaf over data; the
                # norms, the router and the position table over model too,
                # whose inputs are sequence-sharded) holds a partial
                # gradient on each rank of it.
                with torch.no_grad():
                    spmd.reduce_grads(grads, specs, place)
            clock.mark(2)
        with torch.no_grad(), trace.range("train.update"):
            if c.grad_clip_norm > 0:
                _clip_grads(grads, c.grad_clip_norm, specs, place)
            _apply_update(c, leaves, opt, grads)
        clock.end()
        return state, _total(loss, place)

    return step


TRAIN_PHASES = ("forward", "backward", "update")


class _PhaseClock:
    """A train step's phase times on the device's clock, each observed
    into `TRAIN_PHASE_DEVICE_SECONDS` once a step.

    On CUDA four events on the step's stream mark the phases' bounds
    (the step's start, then the end of each of `TRAIN_PHASES`); two sets
    serve in turn, so a step allocates nothing.  A set is read at a
    later step's start once its last event is done (``query``), never
    waited for; one still pending when its turn comes round again, two
    steps on, is dropped.  The events time the device's own clock, so a
    phase includes the device's waits for the host's launches inside
    it.  On a CPU device the ops run as they are issued, so host
    ``perf_counter`` stamps stand in.  A trainer's first step is not
    observed: it builds the kernels and grows the allocator."""

    def __init__(self, device: torch.device):
        self._device = device
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._sets = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                          for _ in range(2)]
        else:
            self._sets = [[0.0] * 4]
        self._pending = [False, False]
        self._turn = 0
        self._steps = 0

    def start(self) -> None:
        if self._cuda:
            for k, events in enumerate(self._sets):
                if self._pending[k] and events[3].query():
                    self._observe([a.elapsed_time(b) * 1e-3 for a, b in zip(events, events[1:])])
                    self._pending[k] = False
            self._pending[self._turn] = False  # pending two steps on: dropped
        self.mark(0)

    def mark(self, i: int) -> None:
        """Bound ``i`` of the step: 0 its start, then the end of each phase."""
        if self._cuda:
            self._sets[self._turn][i].record(torch.cuda.current_stream(self._device))
        else:
            self._sets[0][i] = time.perf_counter()

    def end(self) -> None:
        self.mark(3)
        self._steps += 1
        if self._cuda:
            self._pending[self._turn] = self._steps > 1
            self._turn ^= 1
        elif self._steps > 1:
            stamps = self._sets[0]
            self._observe([b - a for a, b in zip(stamps, stamps[1:])])

    @staticmethod
    def _observe(seconds: "list[float]") -> None:
        for phase, s in zip(TRAIN_PHASES, seconds):
            TRAIN_PHASE_DEVICE_SECONDS.observe(s, phase=phase)


def _shard(t, spec, place: "spmd.Place"):
    """The rank's block of a whole leaf ``t`` (the leaf itself when it is
    not split), in storage of its own."""
    sl = spmd.local_slices(spec, t.shape, place.sizes, place.coords)
    if all(s == slice(0, n) for s, n in zip(sl, t.shape)):
        return t
    return t[sl].clone(memory_format=torch.contiguous_format)


def _init_state(config: BurninConfig, device: "str | torch.device" = "cuda",
                place: "spmd.Place | None" = None):
    """`init_params`' seeded state; with ``place``, the rank's shards of
    it (the same whole tree drawn on every rank, then cut)."""
    params = init_params(config, device=device)
    if place is not None:
        specs = param_specs(config, place.sizes)
        params = {
            "embed": _shard(params["embed"], specs["embed"], place),
            "pos": _shard(params["pos"], specs["pos"], place),
            "layers": {n: _shard(t, specs["layers"][n], place)
                       for n, t in params["layers"].items()},
            "ln_f": params["ln_f"],
        }
    if config.optimizer == "adamw":
        return params, {
            "m": _tree_map(torch.zeros_like, params),
            "v": _tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=params["ln_f"].device),
        }
    return params, _tree_map(torch.zeros_like, params)


def sample_tokens(config: BurninConfig, generator: "torch.Generator | None" = None,
                  device: "str | torch.device" = "cuda", *, key=None):
    """Synthetic (batch, seq) int32 tokens with learnable structure: each
    row walks ``(start + 17 t) % vocab``, and 5% of the positions are
    replaced by random tokens.

    With ``key`` (a `prng` key) the draw is the reference's bit for bit:
    ``k1, k2 = split(key)``, the starts from ``randint(k1)``, and both the
    noise mask (``bernoulli(k2, 0.05)``) and the random tokens
    (``randint(k2)``) from ``k2``, as the reference draws them.
    Otherwise ``generator`` (default: one on ``device`` seeded with 42)
    draws other numbers of the same rule."""
    dev = resolve_device(device)
    c = config
    steps = torch.arange(c.seq, device=dev)[None, :]
    if key is not None:
        k1, k2 = prng.split(torch.as_tensor(key, device=dev))
        start = prng.randint(k1, (c.batch, 1), 0, c.vocab)
        noise = prng.bernoulli(k2, 0.05, (c.batch, c.seq))
        rand = prng.randint(k2, (c.batch, c.seq), 0, c.vocab)
        walk = (start + steps * 17) % c.vocab
        return torch.where(noise, rand, walk).to(torch.int32)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(42)
    start = torch.randint(0, c.vocab, (c.batch, 1), generator=generator, device=dev)
    walk = (start + steps * 17) % c.vocab
    noise = torch.rand((c.batch, c.seq), generator=generator, device=dev) < 0.05
    rand = torch.randint(0, c.vocab, (c.batch, c.seq), generator=generator, device=dev)
    return torch.where(noise, rand, walk).to(torch.int32)


def prepare_tokens(config: BurninConfig, mesh=None, *, device: "str | torch.device" = "cuda"):
    """The synthetic batch on ``device``; on a `DeviceMesh` (``mesh`` may
    also be the device), this rank's rows of it (`token_spec`: the same
    batch drawn on every rank, rows split over ``data`` x ``fsdp``)."""
    mesh, device = _placement(mesh, device)
    if mesh is None:
        return sample_tokens(config, device=device)
    place = spmd.Place(mesh)
    tokens = sample_tokens(config, device=place.device)
    return tokens[spmd.local_slices(token_spec(config), tokens.shape, place.sizes,
                                    place.coords)].contiguous()


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


def train(config: "BurninConfig | None" = None, mesh=None, steps: int = 10,
          device: "str | torch.device" = "cuda") -> TrainReport:
    """Run the burn-in on one ``device``, or sharded over a `DeviceMesh`
    (every rank of it calls this; ``config`` is scaled to the mesh
    first): ``max(2, steps)`` steps on the synthetic batch from
    `init_params`' seeded weights, the loss fetched once a step.
    Reports, never raises: a failure comes back as
    ``TrainReport(ok=False, error=...)``."""
    c = config or BurninConfig()
    try:
        mesh, device = _placement(mesh, device)
        if mesh is not None:
            c = c.scaled_to(mesh)
        step_fn, state = make_train_step(c, mesh, device=device)
        tokens = prepare_tokens(c, mesh, device=device)
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
