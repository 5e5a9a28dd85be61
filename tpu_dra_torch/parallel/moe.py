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
sequence-sharded stream; the load-balance term takes global means.

Under context parallelism the sequence stays sharded over ``model``, and
`moe_mlp_local` routes it in groups (GShard's groups): the capacity
queues run over a group, not the whole sequence.  On a mesh
(`moe_mlp_local_sharded`) a rank's sequence block is its group, so no
sequence is gathered: a rank routes its own block, dispatches to its
own experts on ``expert``, and the combine's partial sums are summed
over ``expert``.  `routing_temp_comparison` measures what that saves.
"""

from __future__ import annotations

import math

import torch

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.utils import trace
from tpu_dra_torch.parallel.mesh import logical_mesh

__all__ = [
    "expert_capacity", "moe_mesh", "moe_mlp", "moe_mlp_local", "moe_mlp_local_sharded",
    "moe_mlp_sharded", "moe_param_specs", "routing_temp_comparison",
]


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


def _dispatch(probs, C: int, dim: int):
    """Switch routing of the router's ``probs`` (.., S, E) into queues of
    ``C`` along ``dim`` (the sequence, or a group's positions): the
    one-hot choice (f32) and the dispatch and combine tensors (.., S, E,
    C), f32.  The gate is the largest probability (its gradient splits
    over ties, as jnp.max's) and the choice the first maximum."""
    gate = probs.amax(dim=-1)
    onehot = torch.nn.functional.one_hot(probs.argmax(dim=-1), probs.shape[-1])  # int64
    # Each token's place in its expert's queue, in sequence order: -1 for
    # the experts it did not choose, C or more when the queue is full.
    # Both match no capacity slot, so such tokens drop out of the dispatch
    # (the reference's one_hot maps out-of-range indices to a zero row).
    pos = torch.cumsum(onehot, dim=dim) - 1
    slots = torch.arange(C, device=probs.device)
    dispatch = ((pos[..., None] == slots) & onehot.bool()[..., None]).float()
    return onehot.float(), dispatch, dispatch * gate[..., None, None]


def moe_mlp(layer, h, config, capacity: "int | None" = None):
    """The MoE MLP half of a block: ``h`` (B, S, d) bf16 post-norm hidden
    states through ``layer``'s ``router`` (d, E) f32 and expert weights
    ``w1e`` (E, d, f), ``w2e`` (E, f, d).  Returns ``(out, aux)``: the
    combined expert outputs (B, S, d) bf16, zero for dropped tokens, and
    the f32 load-balance loss ``E * sum_e frac_e * meanprob_e``.

    ``capacity`` overrides the per-(batch row, expert) queue length (the
    decode path passes the training capacity clamped to the slice
    length).

    Under a profiler the parts are ranges: ``moe.route`` (the router),
    ``moe.dispatch`` (queues, the load-balance term and the tokens'
    gather into the experts' queues), ``moe.experts`` (the expert GEMMs)
    and ``moe.combine``."""
    E = config.moe_experts
    C = expert_capacity(config) if capacity is None else capacity
    bf16 = torch.bfloat16

    with trace.range("moe.route"):
        probs = route(layer, h)
    with trace.range("moe.dispatch"):
        onehot, dispatch, combine = _dispatch(probs, C, dim=1)  # dispatch (B, S, E, C)
        frac = onehot.mean(dim=(0, 1))
        meanp = probs.mean(dim=(0, 1))
        aux = E * torch.sum(frac * meanp)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(bf16), h)
    with trace.range("moe.experts"):
        h1 = torch.einsum("ebcd,edf->ebcf", expert_in, layer["w1e"].to(bf16))
        h1 = torch.where(h1 > 0, h1, _SLOPE * h1)
        out_e = torch.einsum("ebcf,efd->ebcd", h1, layer["w2e"].to(bf16))
    with trace.range("moe.combine"):
        out = torch.einsum("bsec,ebcd->bsd", combine.to(bf16), out_e)
    return out, aux


def moe_mlp_sharded(layer, h, config, place: "spmd.Place", specs,
                    capacity: "int | None" = None, serve: bool = False):
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
    before their product.

    ``serve``: the decode step's form, where the stream is not sharded
    over the sequence: ``capacity`` long queues (`moe_mlp`'s override),
    the output whole over ``model`` (the combine's partial sums
    all-reduced there, or over ``expert``), and no load-balance term
    (``aux`` None)."""
    E = config.moe_experts
    C = expert_capacity(config) if capacity is None else capacity
    bf16 = torch.bfloat16
    ep = "expert" if "expert" in place.sizes else "model"
    n_local = E // place.size(ep)
    e0 = place.index(ep) * n_local

    router = spmd.gather_leaf(layer["router"], specs["router"], place)
    probs = route({"router": router}, h)
    onehot, dispatch, combine = _dispatch(probs, C, dim=1)

    aux = None
    if not serve:
        batch_ranks = place.size("data") * place.size("fsdp")
        frac = spmd.psum(onehot.mean(dim=(0, 1)), place, ("data", "fsdp"))
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
        if serve:
            return spmd.psum(out, place, "model"), aux
        return spmd.scatter(out, place, "model", 1), aux
    out = spmd.psum(out, place, "expert")
    if serve:
        return out, aux
    n = out.shape[1] // place.size("model")
    lo = place.index("model") * n
    return out[:, lo:lo + n], aux


def moe_mlp_local(layer, h, config, groups: int):
    """Group-local switch routing (the reference's ``moe_mlp_local`` on
    one device): ``h`` (B, S, d) bf16 split into ``groups`` groups of
    S / groups positions, (B, S, d) -> (B, G, S/G, d), each routed on its
    own: the capacity cumsum runs over the group's positions and the
    capacity is `expert_capacity` per group.  The load-balance term takes
    the means over every token.  Rounding points as `moe_mlp`'s.
    Returns ``(out, aux)`` as `moe_mlp` does."""
    E = config.moe_experts
    B, S, D = h.shape
    if S % groups:
        raise ValueError(f"seq {S} not divisible by {groups} routing groups")
    C = expert_capacity(config, groups=groups)
    bf16 = torch.bfloat16

    hg = h.reshape(B, groups, S // groups, D)
    probs = route(layer, hg)  # (B, G, Sl, E)
    onehot, dispatch, combine = _dispatch(probs, C, dim=2)
    frac = onehot.mean(dim=(0, 1, 2))
    meanp = probs.mean(dim=(0, 1, 2))
    aux = E * torch.sum(frac * meanp)

    expert_in = torch.einsum("bgsec,bgsd->ebgcd", dispatch.to(bf16), hg)
    h1 = torch.einsum("ebgcd,edf->ebgcf", expert_in, layer["w1e"].to(bf16))
    h1 = torch.where(h1 > 0, h1, _SLOPE * h1)
    out_e = torch.einsum("ebgcf,efd->ebgcd", h1, layer["w2e"].to(bf16))
    out = torch.einsum("bgsec,ebgcd->bgsd", combine.to(bf16), out_e)
    return out.reshape(B, S, D), aux


def moe_mlp_local_sharded(layer, h, config, place: "spmd.Place", specs):
    """`moe_mlp_local` on a rank's shards, one group a rank's sequence
    block on ``model`` (the cp layout): ``h`` (B_local, S / model, d)
    bf16 is the rank's block, routed where it lies (no sequence gather),
    with the capacity of ``model`` groups.  The rank dispatches to its
    own experts on ``expert`` (the leaves' ``specs`` put them there; the
    router and the expert matrices are gathered over ``fsdp`` at use,
    d_ff whole), and the combine's partial sums are summed over
    ``expert``.  ``frac`` and ``meanp`` are averaged over the batch axes
    and ``model`` (every token of the global batch) before their product.

    Returns ``(out, aux)``: ``out`` (B_local, S / model, d) bf16, the
    rank's block of the outputs; ``aux`` the load-balance term."""
    E = config.moe_experts
    G = place.size("model")
    C = expert_capacity(config, groups=G)
    bf16 = torch.bfloat16
    n_local = E // place.size("expert")
    e0 = place.index("expert") * n_local

    router = spmd.gather_leaf(layer["router"], specs["router"], place)
    probs = route({"router": router}, h)  # (B, Sl, E)
    onehot, dispatch, combine = _dispatch(probs, C, dim=1)
    axes = ("data", "fsdp", "model")
    ranks = math.prod(place.size(a) for a in axes)
    frac = spmd.psum(onehot.mean(dim=(0, 1)), place, axes)
    meanp = spmd.psum(probs.mean(dim=(0, 1)), place, axes)
    if ranks > 1:
        frac, meanp = frac / ranks, meanp / ranks
    aux = E * torch.sum(frac * meanp)

    dispatch = dispatch[:, :, e0:e0 + n_local]
    combine = combine[:, :, e0:e0 + n_local]
    w1e = spmd.gather_leaf(layer["w1e"], specs["w1e"], place, dtype=bf16)
    w2e = spmd.gather_leaf(layer["w2e"], specs["w2e"], place, dtype=bf16)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(bf16), h)
    h1 = torch.einsum("ebcd,edf->ebcf", expert_in, w1e)
    h1 = torch.where(h1 > 0, h1, _SLOPE * h1)
    out_e = torch.einsum("ebcf,efd->ebcd", h1, w2e)
    out = torch.einsum("bsec,ebcd->bsd", combine.to(bf16), out_e)
    return spmd.psum(out, place, "expert"), aux


def routing_temp_comparison(mesh, *, seq: int = 512, d_model: int = 16, d_ff: int = 32,
                            experts: int = 4):
    """The activation bound of group-local routing (the reference's
    ``routing_temp_comparison``): on this rank of ``mesh`` (a `moe_mesh`
    with a ``model`` axis), the card's peak allocation above the start
    during one forward of each MoE form on the same sequence-sharded
    input — the global form (the sequence gathered over ``model``, then
    `moe_mlp_sharded`) and the group-local one (`moe_mlp_local_sharded`
    on the rank's block).  Returns ``(global_bytes, local_bytes)``, or
    None off CUDA (the reference returns None where the backend has no
    memory analysis).  Every rank of the mesh calls it.  The caller
    asserts with a margin (``local * 1.4 < global`` at ``model`` 2)."""
    place = spmd.Place(mesh)
    if place.device.type != "cuda":
        return None
    return _routing_peaks(place, _cuda_peak_bytes, seq=seq, d_model=d_model, d_ff=d_ff,
                          experts=experts)


def _cuda_peak_bytes(fn, device) -> int:
    """The card's peak allocation above the start while ``fn`` runs."""
    torch.cuda.synchronize(device)
    start = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    del out
    return torch.cuda.max_memory_allocated(device) - start


def _routing_peaks(place: "spmd.Place", peak, *, seq: int, d_model: int, d_ff: int,
                   experts: int):
    """``(peak(global form), peak(local form))`` on the rank's shards of
    one layer (`routing_temp_comparison`'s config and input), each form
    a no-grad forward handed to ``peak(fn, device)``."""
    from tpu_dra_torch.parallel import burnin  # burnin imports this module

    c = burnin.BurninConfig(n_layers=1, seq=seq, d_model=d_model, d_ff=d_ff,
                            ring_attention=True, moe_experts=experts).scaled_to(place.sizes)
    whole = {k: v[0] for k, v in burnin.init_params(c, device=place.device)["layers"].items()}

    def layer(ring: bool):
        # The rank's shards of layer 0 and their specs: the global form's
        # expert FFN is over model (ep x tp), the local one's is whole.
        specs = {name: spec[1:] for name, spec in moe_param_specs("expert", ring=ring).items()}
        return {name: whole[name][spmd.local_slices(spec, whole[name].shape, place.sizes,
                                                     place.coords)]
                for name, spec in specs.items()}, specs

    rows = c.batch // (place.size("data") * place.size("fsdp"))
    h = torch.zeros((rows, c.seq // place.size("model"), c.d_model), dtype=torch.bfloat16,
                    device=place.device)
    (g_layer, g_specs), (l_layer, l_specs) = layer(False), layer(True)

    @torch.no_grad()
    def global_form():
        return moe_mlp_sharded(g_layer, spmd.gather(h, place, "model", 1), c, place, g_specs)[0]

    @torch.no_grad()
    def local_form():
        return moe_mlp_local_sharded(l_layer, h, c, place, l_specs)[0]

    return peak(global_form, place.device), peak(local_form, place.device)
