"""Pipeline parallelism: a GPipe schedule over a ``pipe`` mesh axis.

Counterpart of `tpu_dra.parallel.pipeline`, over `torch.distributed`.
The layer stack is split into P contiguous stages, stage i held by the
ranks at index i on ``pipe`` (`burnin.param_specs` puts every layer
leaf's stacked dim there), and M microbatches stream through the stages
in M + P - 1 ticks.  At tick t stage i runs microbatch t - i when it is
active (``i <= t < i + M``), then every rank takes part in one hop along
the line of stages (`spmd.line_hop`): its output goes one stage down,
the previous stage's comes in.  Inside a stage the blocks are the
sharded training's (`burnin._block_sharded`): Megatron tp and sp over
``model``, experts over ``model``, the batch over ``data`` only (the
pipe mesh has no ``fsdp``).

Where the reference differentiates its ``lax.scan`` (a ring ``ppermute``
whose transpose is the reverse ring), the port writes the reverse
schedule by hand (`_GPipe`): autograd would neither issue the hop that
stage 0 discards in the ring nor order the hops of one rank's graph as
its neighbour's.  The forward runs the ticks under ``no_grad`` and keeps
each active tick's stage input; the backward runs the ticks in reverse
on every rank in the same order: one reverse hop (a stage's input
cotangent one stage up), then the stage recomputed under ``enable_grad``
(the reference's ``jax.checkpoint`` on the block) and differentiated.
The last stage takes its output's cotangent from the loss.  A stage
skips the compute of its inactive ticks, whose results the reference
masks out; every rank of a ``model`` or ``data`` group shares its pipe
index, so the groups' collectives stay in step.

The last stage's outputs are made whole on every pipe rank, and the
stages' load-balance terms summed over ``pipe``, in one all-reduce (the
reference's masked ``psum``); the backward sums the cotangents the same
way.  The load-balance term counts a stage's active ticks only and is
the mean over microbatches.

Microbatch j is the reference's: global rows ``[j B/M, (j+1) B/M)``,
split over ``data``.  A rank holds its ``token_spec`` rows, so when
``data`` and M are both above 1 the pipelined forward first takes the
rows it computes from the tokens gathered over ``data`` (int32, small),
and `forward_pipelined` hands the logits of the rank's own rows back
(the training loss takes the rows as computed: a sum over rows is the
same in any order).  The MoE load-balance term, which is not linear in
the rows, is then the reference's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.mesh import _device_type, _mesh_over

__all__ = ["forward_pipelined", "microbatch_rows", "own_rows", "pipeline_mesh",
           "pipeline_sizes"]


def pipeline_sizes(n: int, *, stages: int, data: int = -1, model: int = 1) -> "dict[str, int]":
    """The (data, pipe, model) axis sizes of `pipeline_mesh` over ``n``
    ranks, checked with the reference's messages (no process group
    needed)."""
    if n % (stages * model):
        raise ValueError(f"{n} devices not divisible into {stages} stages x {model} model")
    if data == -1:
        data = n // (stages * model)
    if data * stages * model != n:
        raise ValueError(f"mesh data={data} x pipe={stages} x model={model} != {n} devices")
    return {"data": data, "pipe": stages, "model": model}


def pipeline_mesh(ranks=None, *, stages: int, data: int = -1, model: int = 1):
    """A (data, pipe, model) mesh over ``ranks`` (default: every rank of
    the process group; in a gang, this host's block of them).  ``model``
    innermost (the per-layer collectives ride the nearest ranks),
    ``pipe`` next (one activation hop a tick), ``data`` outermost.  The
    sizes are checked before any process group is touched."""
    if ranks is None:
        ranks = range(dist.get_world_size()) if dist.is_initialized() else [0]
    ranks = [int(r) for r in ranks]
    sizes = pipeline_sizes(len(ranks), stages=stages, data=data, model=model)
    return _mesh_over(_device_type(), ranks, tuple(sizes.values()), tuple(sizes))


def check_config(config, place: "spmd.Place") -> None:
    """The reference's divisibility refusals of ``forward_pipelined``."""
    stages, M = place.size("pipe"), config.pipeline_microbatches
    if config.n_layers % stages:
        raise ValueError(f"n_layers {config.n_layers} not divisible by {stages} pipeline stages")
    if config.batch % (place.size("data") * M):
        raise ValueError(
            f"batch {config.batch} not divisible by data {place.size('data')} "
            f"x microbatches {M}"
        )


def _reordered(config, place: "spmd.Place") -> bool:
    return place.size("data") > 1 and config.pipeline_microbatches > 1


def _computed_rows(config, place: "spmd.Place", d: int) -> torch.Tensor:
    """The global rows the rank at index ``d`` on ``data`` computes, in
    order: its part of microbatch 0, then of microbatch 1, ..."""
    M, data = config.pipeline_microbatches, place.size("data")
    per_mb = config.batch // M
    part = per_mb // data
    return torch.cat([torch.arange(j * per_mb + d * part, j * per_mb + (d + 1) * part)
                      for j in range(M)])


def microbatch_rows(tokens, config, place: "spmd.Place"):
    """The token rows this rank computes, microbatch-major, from its
    ``token_spec`` rows ``tokens`` (the same tensor when the order is
    already the reference's: one ``data`` rank, or one microbatch)."""
    if not _reordered(config, place):
        return tokens
    whole = spmd.gather(tokens, place, "data", 0)
    return whole[_computed_rows(config, place, place.index("data")).to(tokens.device)]


def own_rows(y, config, place: "spmd.Place"):
    """The inverse of `microbatch_rows` on a per-row tensor ``y`` (the
    rank's computed rows first): the rank's own ``token_spec`` rows,
    gathered over ``data`` (its backward reduce-scatters)."""
    if not _reordered(config, place):
        return y
    computed = torch.cat([_computed_rows(config, place, d)
                          for d in range(place.size("data"))])
    where = torch.argsort(computed)  # where each global row lies once gathered
    rows = config.batch // place.size("data")
    mine = where[place.index("data") * rows:(place.index("data") + 1) * rows]
    return spmd.gather(y, place, "data", 0)[mine.to(y.device)]


class _Stage:
    """What the schedule needs besides its tensors: the config, the
    rank's place, the per-layer specs, the RoPE tables and the layer
    leaves' names."""

    def __init__(self, config, place: "spmd.Place", specs, rope_tab, names):
        self.config, self.place, self.specs = config, place, specs
        self.rope_tab, self.names = rope_tab, names
        self.M = config.pipeline_microbatches
        self.P, self.i = place.size("pipe"), place.index("pipe")

    def active(self, t: int) -> bool:
        return self.i <= t < self.i + self.M

    def run(self, leaves, h):
        """The stage's L/P blocks on ``h``: ``(h, aux)``, ``aux`` the
        blocks' summed load-balance term (a zero without experts)."""
        from tpu_dra_torch.parallel.burnin import _block_sharded  # burnin imports this module

        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for per_layer in zip(*(leaf.unbind(0) for leaf in leaves)):
            h, a = _block_sharded(dict(zip(self.names, per_layer)), h, config=self.config,
                                  place=self.place, specs=self.specs, rope_tab=self.rope_tab)
            if a is not None:
                aux = aux + a
        return h, aux


def _whole_over_pipe(out, aux, place: "spmd.Place"):
    """``out`` summed over ``pipe`` (every stage but the last holds
    zeros) and ``aux`` summed there, in one f32 all-reduce."""
    if place.size("pipe") == 1:
        return out, aux
    flat = torch.cat([out.reshape(-1).float(), aux.reshape(1).float()])
    dist.all_reduce(flat, group=place.group("pipe"))
    return flat[:-1].view(out.shape).to(out.dtype), flat[-1]


class _GPipe(torch.autograd.Function):
    """The GPipe schedule with its reverse written by hand (see the
    module docstring).  ``x`` is the rank's block of the stream, rows
    microbatch-major; ``leaves`` the stage's stacked layer leaves.
    Returns the last stage's output (whole on every pipe rank) and the
    stages' summed load-balance terms."""

    @staticmethod
    def forward(ctx, x, stage: _Stage, *leaves):
        place, M, P, i = stage.place, stage.M, stage.P, stage.i
        feed = x.chunk(M)
        kept, outs, state = [], [], None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(M + P - 1):
            if stage.active(t):
                cur = feed[t] if i == 0 else state
                kept.append(cur)
                y, a = stage.run(leaves, cur)
                aux = aux + a
                if i == P - 1:
                    outs.append(y)
            else:
                y = torch.zeros_like(feed[0])
            state = spmd.line_hop(y, place, "pipe")
        out = torch.cat(outs) if i == P - 1 else torch.zeros_like(x)
        ctx.stage, ctx.kept, ctx.leaves = stage, kept, leaves
        return _whole_over_pipe(out, aux, place)

    @staticmethod
    def backward(ctx, g_out, g_aux):
        stage = ctx.stage
        place, M, P, i = stage.place, stage.M, stage.P, stage.i
        g_out, g_aux = _whole_over_pipe(g_out.contiguous(), g_aux, place)
        g_last = g_out.chunk(M)
        g_leaves = [torch.zeros_like(leaf) for leaf in ctx.leaves]
        g_feed = [None] * M
        kept = list(ctx.kept)
        g_sent = None
        for t in reversed(range(M + P - 1)):
            g_y = spmd.line_hop(g_sent if g_sent is not None else torch.zeros_like(g_last[0]),
                                place, "pipe", reverse=True)
            g_sent = None
            if not stage.active(t):
                continue
            if i == P - 1:
                g_y = g_last[t - i]
            cur = kept.pop().detach().requires_grad_()
            leaves = [leaf.detach().requires_grad_() for leaf in ctx.leaves]
            with torch.enable_grad():
                y, a = stage.run(leaves, cur)
            outputs, cotangents = [y], [g_y]
            if a.requires_grad:
                outputs.append(a)
                cotangents.append(g_aux)
            grads = torch.autograd.grad(outputs, [cur, *leaves], cotangents, allow_unused=True)
            g_sent = grads[0]
            for acc, g in zip(g_leaves, grads[1:]):
                if g is not None:
                    acc.add_(g)
            if i == 0:
                g_feed[t] = g_sent
        g_x = torch.cat(g_feed) if i == 0 else torch.zeros_like(g_out)
        del ctx.kept, ctx.leaves
        return (g_x, None, *g_leaves)


def pipelined_blocks(layers, x, config, place: "spmd.Place", specs, rope_tab=None):
    """The stacked blocks of ``layers`` (the rank's stage: L/P layers of
    each leaf) as a P-stage GPipe pipeline over ``pipe``, on ``x`` the
    rank's (B_rows, S / model, d) f32 block of the stream, rows
    microbatch-major.  ``specs`` are the per-layer leaves' layouts.
    Returns ``(x, aux)``: the stack's output (whole on every pipe rank)
    and the load-balance term, summed over the stages and averaged over
    the microbatches."""
    names = list(layers)
    stage = _Stage(config, place, specs, rope_tab, names)
    out, aux = _GPipe.apply(x, stage, *(layers[n] for n in names))
    return out, aux / config.pipeline_microbatches


def forward_pipelined(params, tokens, config, mesh):
    """Pipelined logits on this rank of a (data, pipe, model) `DeviceMesh`:
    ``params`` its shards (`burnin.param_specs`: its stage's layers, the
    embedding, position table and final norm whole), ``tokens`` its rows
    (`burnin.token_spec`).  The embedding and the tied logits are
    computed on every pipe rank; the blocks run the GPipe schedule with
    tp, sp and experts live inside each stage.  Returns ``(logits,
    aux)``: the rank's block of the logits, (B / data, S / model,
    vocab) f32, the sequence block its place on ``model``, and the
    load-balance term averaged over microbatches (0.0 for dense MLPs)."""
    from tpu_dra_torch.parallel import burnin  # burnin imports this module

    place = spmd.Place(mesh)
    check_config(config, place)
    logits, aux = burnin._forward_sharded(params, microbatch_rows(tokens, config, place),
                                          config, place, True)
    return own_rows(logits, config, place), aux
