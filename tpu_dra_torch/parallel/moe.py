"""The switch-routed mixture-of-experts MLP of the burn-in LM, on one device.

Counterpart of `tpu_dra.parallel.moe`'s `expert_capacity` and
`moe_mlp` (the unsharded path).  Routing is top-1 ("switch") with a
capacity per (batch row, expert): each token goes to the expert of its
largest router probability, takes the next place in that expert's queue
in sequence order, and is dropped when the queue is full (its MLP output
is zero; the residual stream carries it on).  The dispatch and the
combine are the reference's dense one-hot products, so every shape is
static and the rounding points are the reference's:

- routing is f32: ``h`` widened to f32 against the f32 ``router``, then
  softmax, max (the gate) and argmax (the first index on ties);
- the dispatch and combine tensors are rounded to bf16 before their
  products, so a kept token's output is ``bf16(bf16(gate) * out_e)``;
- the expert weights are bf16 at use; each product accumulates in f32
  and stores bf16; the leaky ReLU's slope is the bf16-rounded 0.01.

The mesh forms (`moe_mlp_local`, `moe_mesh`, `moe_param_specs`) are not
ported: the port runs on one device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["expert_capacity", "moe_mlp"]

# The leaky ReLU's slope as the reference applies it to a bf16 array (a
# weakly typed Python scalar rounds to bf16 first).
_SLOPE = float(torch.tensor(0.01, dtype=torch.bfloat16))


def expert_capacity(config, groups: int = 1) -> int:
    """Static per-(batch-row, expert) token capacity; with ``groups`` > 1
    the sequence is routed in that many independent groups and the
    capacity is per group."""
    c = config
    return max(1, math.ceil(c.seq / groups / c.moe_experts * c.moe_capacity))


def route(layer, h):
    """The router's f32 probabilities (B, S, E) of post-norm hidden states
    ``h`` (B, S, d): ``softmax(f32(h) @ router)``."""
    return torch.softmax(h.float() @ layer["router"], dim=-1)


def moe_mlp(layer, h, config, capacity: "int | None" = None):
    """The MoE MLP half of a block: ``h`` (B, S, d) bf16 post-norm hidden
    states through ``layer``'s ``router`` (d, E) f32 and expert weights
    ``w1e`` (E, d, f), ``w2e`` (E, f, d).  Returns ``(out, aux)``: the
    combined expert outputs (B, S, d) bf16, zero for dropped tokens, and
    the f32 load-balance loss ``E * sum_e frac_e * meanprob_e``.

    ``capacity`` overrides the per-(batch row, expert) queue length (the
    decode path passes the training capacity clamped to the slice
    length)."""
    E = config.moe_experts
    C = expert_capacity(config) if capacity is None else capacity
    bf16 = torch.bfloat16

    probs = route(layer, h)
    gate = probs.amax(dim=-1)  # (B, S); its gradient splits over ties, as jnp.max's
    choice = probs.argmax(dim=-1)  # (B, S): the first maximum
    onehot = torch.nn.functional.one_hot(choice, E)  # (B, S, E) int64
    # Each token's place in its expert's queue, in sequence order: -1 for
    # the experts it did not choose, C or more when the queue is full.
    # Both match no capacity slot, so such tokens drop out of the dispatch
    # (the reference's one_hot maps out-of-range indices to a zero row).
    pos = torch.cumsum(onehot, dim=1) - 1
    slots = torch.arange(C, device=h.device)
    dispatch = ((pos[..., None] == slots) & onehot.bool()[..., None]).float()  # (B, S, E, C)
    combine = dispatch * gate[..., None, None]

    onehot = onehot.float()
    frac = onehot.mean(dim=(0, 1))
    meanp = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * meanp)

    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(bf16), h)
    h1 = torch.einsum("ebcd,edf->ebcf", expert_in, layer["w1e"].to(bf16))
    h1 = torch.where(h1 > 0, h1, _SLOPE * h1)
    out_e = torch.einsum("ebcf,efd->ebcd", h1, layer["w2e"].to(bf16))
    out = torch.einsum("bsec,ebcd->bsd", combine.to(bf16), out_e)
    return out, aux
