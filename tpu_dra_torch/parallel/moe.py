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

On a mesh (`moe_mesh`, `moe_param_specs`, `moe_mlp_sharded`) the
tokens entering the MLP are whole over the axes the experts ride (the tp
region), so each rank dispatches to its own experts from the same
routing, and the combine's partial sums are reduced back into the
sequence-sharded stream; the load-balance term takes global means.  The
cp x ep form (`moe_mlp_local`, group-local routing) is not ported.
"""

from __future__ import annotations

import math

import torch

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.mesh import logical_mesh

__all__ = ["expert_capacity", "moe_mesh", "moe_mlp", "moe_mlp_sharded", "moe_param_specs"]


def moe_mesh(ranks=None, *, data: int = -1, fsdp: int = 1, model: int = 1, expert: int = 1):
    """A (data, fsdp, model, expert) mesh over ``ranks``: experts on their
    own axis, innermost (the dispatch of every MoE layer rides the
    nearest ranks), each expert's FFN Megatron-sharded over ``model``
    (ep x tp).  Sizes are inferred and checked as `mesh.logical_mesh`
    does."""
    return logical_mesh(ranks, data=data, fsdp=fsdp, model=model, expert=expert)


def moe_param_specs(expert_axis: str = "model", ring: bool = False):
    """The MoE leaves' specs (the reference's, as `burnin.param_specs`
    writes them).  ``expert_axis="model"``: experts ride the tp axis.
    ``"expert"``: experts on their own axis, each expert's FFN hidden dim
    over ``model`` — unless ``ring`` (cp x ep), where the model axis
    carries the sequence and d_ff is replicated over it."""
    if expert_axis == "expert":
        if ring:
            return {
                "router": (None, "fsdp", None),
                "w1e": (None, "expert", "fsdp", None),
                "w2e": (None, "expert", None, "fsdp"),
            }
        return {
            "router": (None, "fsdp", None),
            "w1e": (None, "expert", "fsdp", "model"),
            "w2e": (None, "expert", "model", "fsdp"),
        }
    return {
        "router": (None, "fsdp", None),
        "w1e": (None, "model", "fsdp", None),
        "w2e": (None, "model", None, "fsdp"),
    }

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


def moe_mlp_sharded(layer, h, config, place: "spmd.Place", specs):
    """`moe_mlp` on a rank's shards.  ``h`` (B_local, S, d) bf16 is whole
    over the sequence and over the axes the experts ride, so the routing
    (f32, as `moe_mlp`'s, capacity per batch row from the cumsum over the
    whole sequence) is the same on every rank of them, and each rank
    dispatches to and combines from its own experts only.  ``layer`` holds
    the rank's shards (``specs`` their layouts): the router and the
    expert matrices are gathered over ``fsdp`` at use.

    Returns ``(out, aux)``: ``out`` (B_local, S / model, d) bf16, the
    rank's block of the combined outputs in the sequence-sharded stream
    (experts over ``model``: a reduce-scatter of the combine's partial
    sums; experts over ``expert``, their FFN over ``model``: the FFN's
    partial sums all-reduced over ``model``, the combine's over
    ``expert``, then the rank's block); ``aux`` the load-balance term of
    global means: ``frac`` and ``meanp`` are averaged over the batch axes
    before their product."""
    E = config.moe_experts
    C = expert_capacity(config)
    bf16 = torch.bfloat16
    ep = "expert" if "expert" in place.sizes else "model"
    n_local = E // place.size(ep)
    e0 = place.index(ep) * n_local

    router = spmd.gather_leaf(layer["router"], specs["router"], place)
    probs = torch.softmax(h.float() @ router, dim=-1)
    gate = probs.amax(dim=-1)
    choice = probs.argmax(dim=-1)
    onehot = torch.nn.functional.one_hot(choice, E)
    pos = torch.cumsum(onehot, dim=1) - 1
    slots = torch.arange(C, device=h.device)
    dispatch = ((pos[..., None] == slots) & onehot.bool()[..., None]).float()
    combine = dispatch * gate[..., None, None]

    batch_ranks = place.size("data") * place.size("fsdp")
    frac = spmd.psum(onehot.float().mean(dim=(0, 1)), place, ("data", "fsdp"))
    meanp = spmd.psum(probs.mean(dim=(0, 1)), place, ("data", "fsdp"))
    if batch_ranks > 1:
        frac, meanp = frac / batch_ranks, meanp / batch_ranks
    aux = E * torch.sum(frac * meanp)

    dispatch = dispatch[:, :, e0:e0 + n_local]
    combine = combine[:, :, e0:e0 + n_local]
    w1e = spmd.gather_leaf(layer["w1e"], specs["w1e"], place, dtype=bf16)
    w2e = spmd.gather_leaf(layer["w2e"], specs["w2e"], place, dtype=bf16)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(bf16), h)
    h1 = torch.einsum("ebcd,edf->ebcf", expert_in, w1e)
    h1 = torch.where(h1 > 0, h1, _SLOPE * h1)
    out_e = torch.einsum("ebcf,efd->ebcd", h1, w2e)
    if ep == "expert":
        out_e = spmd.psum(out_e, place, "model")  # each expert's FFN partial sums
    out = torch.einsum("bsec,ebcd->bsd", combine.to(bf16), out_e)
    if ep == "model":
        return spmd.scatter(out, place, "model", 1), aux
    out = spmd.psum(out, place, "expert")
    n = out.shape[1] // place.size("model")
    lo = place.index("model") * n
    return out[:, lo:lo + n], aux
