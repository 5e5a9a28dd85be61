"""The sharded training step's layout and collectives over a `DeviceMesh`.

The reference states where each array lives as a ``PartitionSpec`` and
lets XLA place the collectives (`tpu_dra.parallel.burnin.make_constrain`).
PyTorch runs one process a rank, so the port states both itself:

- a **spec** is a tuple with one entry a dim: None (replicated), an axis
  name, or a tuple of names (the reference's ``P(("data", "fsdp"))``);
  `local_slices` turns it into the slices a rank holds;
- `Place` is a rank's place on a mesh: the axis sizes, its index on each
  and each axis's process group;
- `gather`, `scatter` and `psum` are autograd collectives over one axis,
  each the other's adjoint: an all-gather whose backward reduce-scatters
  the gradient, a reduce-scatter whose backward all-gathers it, an
  all-reduce whose backward all-reduces it; `all_to_all` swaps which dim
  is split over an axis (its backward is the inverse swap); `shift` is
  one hop of a ring, `line_hop` one hop along a line (the pipeline's
  stage to stage move, driven by hand in both directions: no gradient).

A step is differentiated as the sum of every rank's local loss: a rank
adds only its share (work repeated on k ranks is counted 1/k on each),
so the collectives' adjoints above give each rank the exact gradient of
the shard it holds from everything downstream of it.  A leaf replicated
over an axis then holds a partial gradient on each rank of that axis, and
`reduce_grads` sums it there.

Sums across ranks are taken in f32 and rounded once to the operand's
dtype: the rounding points are the single-device step's, only the order
of the cross-rank sums differs.  Over an axis of size 1 every collective
is the identity (or the cast it carries), so a one-rank mesh runs the
single-device arithmetic.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping

import torch
import torch.distributed as dist

from tpu_dra_torch.parallel.collectives import rank_device
from tpu_dra_torch.parallel.mesh import mesh_shape

__all__ = [
    "Place", "all_to_all", "all_to_all_local", "gather", "gather_leaf", "line_hop",
    "local_slices", "mesh_sizes", "psum", "reduce_grads", "scatter", "shift", "spec_axes",
]


def mesh_sizes(mesh) -> "dict[str, int]":
    """``{axis: size}`` of a `DeviceMesh`, or of a mapping that already is
    one (the layout functions take either, so that they run without a
    process group)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return mesh_shape(mesh)


def spec_axes(spec) -> "tuple[str, ...]":
    """Every axis a spec names, in dim order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend(entry if isinstance(entry, tuple) else (entry,))
    return tuple(out)


def local_slices(spec, shape, sizes: "dict[str, int]", coords: "dict[str, int]"):
    """The slices of a leaf of ``shape`` laid out by ``spec`` that the rank
    at ``coords`` holds: each named dim cut into equal blocks, the block
    index the rank's index on the axis (major to minor over a tuple of
    axes, as the reference orders them)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit a leaf of shape {tuple(shape)}")
    out = []
    for entry, n in zip(spec, shape):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        parts, block = 1, 0
        for a in axes:
            parts *= sizes.get(a, 1)
            block = block * sizes.get(a, 1) + coords.get(a, 0)
        if n % parts:
            raise ValueError(f"dim of {n} does not split over {axes} ({parts} ways)")
        step = n // parts
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


class Place:
    """A rank's place on ``mesh``: the axis sizes, its index on each, each
    axis's group and the rank's device.  An axis the mesh lacks has size 1."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.coords = {a: mesh.get_local_rank(a) for a in self.sizes}
        self.device = rank_device(mesh)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    @property
    def world(self) -> int:
        n = 1
        for s in self.sizes.values():
            n *= s
        return n


def _gather_dim(x, dim: int, group, n: int):
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=xs.dtype, device=xs.device)
    with warnings.catch_warnings():
        # Newer torch renames it all_gather_single; older has only this name.
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter_dim(x, dim: int, group, n: int, dtype):
    """Reduce-scatter of ``x`` along ``dim``, summed in f32, as ``dtype``."""
    xs = x.movedim(dim, 0).to(torch.float32).contiguous()
    out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=torch.float32, device=xs.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # as above: reduce_scatter_single
        dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim).to(dtype).contiguous()


def _sum(x, group):
    # A copy in storage of its own: an einsum's output may be a permuted
    # view, which NCCL refuses ("Tensors must be contiguous").
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, dtype):
        ctx.dim, ctx.group, ctx.n, ctx.in_dtype = dim, group, n, x.dtype
        return _gather_dim(x.to(dtype), dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group, ctx.n, ctx.in_dtype), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _scatter_dim(x, dim, group, n, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def _a2a_send(x, split_dim: int, n: int):
    """``x`` cut into ``n`` chunks along ``split_dim``, chunk j at index j
    of a new leading dim, in storage of its own (NCCL refuses a tensor
    that is not contiguous)."""
    shape = x.shape
    parts = x.reshape(*shape[:split_dim], n, shape[split_dim] // n, *shape[split_dim + 1:])
    return parts.movedim(split_dim, 0).contiguous()


def _a2a_recv(recv, concat_dim: int, n: int):
    """The chunks received (chunk i from rank i at index i of the leading
    dim) concatenated along ``concat_dim`` in rank order."""
    shape = list(recv.shape[1:])
    shape[concat_dim] *= n
    return recv.movedim(0, concat_dim).reshape(shape)


def _a2a(x, split_dim: int, concat_dim: int, group, n: int):
    send = _a2a_send(x, split_dim, n)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return _a2a_recv(recv, concat_dim, n)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, n):
        ctx.dims, ctx.group, ctx.n = (split_dim, concat_dim), group, n
        return _a2a(x, split_dim, concat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, concat_dim, split_dim, ctx.group, ctx.n), None, None, None, None


def all_to_all(x, place: Place, axis: str, split_dim: int, concat_dim: int):
    """The all-to-all over ``axis`` that ``jax.lax.all_to_all(...,
    tiled=True)`` is: ``split_dim`` cut into as many chunks as the axis
    has ranks, chunk j sent to rank j, and the chunks received
    concatenated along ``concat_dim`` in rank order.  Returns a
    contiguous tensor; the backward is the same call with the two dims
    swapped (the inverse permutation, which is its adjoint)."""
    n = place.size(axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {axis} "
                         f"({n} ways)")
    return _AllToAll.apply(x, split_dim, concat_dim, place.group(axis), n)


def all_to_all_local(xs, split_dim: int, concat_dim: int):
    """What `all_to_all` gives every rank of an axis whose ranks hold
    ``xs`` (in rank order), computed in one process by the same packing
    and unpacking, the exchange done by indexing: a rank's output without
    a process group (the smoke run lays out each rank's tensors so)."""
    n = len(xs)
    sends = [_a2a_send(x, split_dim, n) for x in xs]
    return [_a2a_recv(torch.stack([s[r] for s in sends]), concat_dim, n)
            for r in range(n)]


def gather(x, place: Place, axis: str, dim: int, dtype=None):
    """All-gather ``x`` along ``dim`` over ``axis`` (cast to ``dtype``
    first, when given); the backward reduce-scatters the gradient in f32
    back to ``x``'s dtype."""
    dtype = x.dtype if dtype is None else dtype
    n = place.size(axis)
    if n == 1:
        return x.to(dtype)
    return _Gather.apply(x, dim, place.group(axis), n, dtype)


def scatter(x, place: Place, axis: str, dim: int):
    """Reduce-scatter ``x`` along ``dim`` over ``axis``: the sum of every
    rank's ``x`` (in f32, rounded once to ``x``'s dtype), this rank's block
    of it; the backward all-gathers the gradient."""
    n = place.size(axis)
    if n == 1:
        return x
    return _Scatter.apply(x, dim, place.group(axis), n)


def psum(x, place: Place, axes):
    """All-reduce ``x`` over ``axes`` (a name or a tuple of names), summed
    in f32 and rounded once to ``x``'s dtype at each axis; the backward
    all-reduces the gradient the same way."""
    for axis in (axes,) if isinstance(axes, str) else axes:
        if place.size(axis) > 1:
            x = _Sum.apply(x, place.group(axis))
    return x


def gather_leaf(x, spec, place: Place, axes=("fsdp",), dtype=None):
    """A leaf's shard made whole over ``axes`` (the dims ``spec`` shards
    over them, each gathered in turn), cast to ``dtype`` when given: a
    weight at its use (ZeRO-3), its gradient reduce-scattered back."""
    for dim, entry in enumerate(spec):
        if entry in axes:
            x = gather(x, place, entry, dim, dtype)
    return x if dtype is None else x.to(dtype)


def shift(tensors, place: Place, axis: str):
    """One hop of the ring along ``axis``: each tensor sent to the next
    rank, and the previous rank's received in its place (no gradient)."""
    n = place.size(axis)
    if n == 1:
        return list(tensors)
    group, i = place.group(axis), place.index(axis)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


def line_hop(x, place: Place, axis: str, *, reverse: bool = False):
    """One hop along the line of ``axis`` (no ring: the ends do not join),
    one `batch_isend_irecv` on contiguous buffers: ``x`` sent to the next
    rank and the previous rank's tensor received, or with ``reverse`` to
    the previous rank and from the next.  Returns the tensor received,
    None on the rank that has no sender (the first, or the last with
    ``reverse``) and when the axis has one rank.  No gradient: the
    pipeline drives the reverse hops of its backward itself."""
    n, i = place.size(axis), place.index(axis)
    if n == 1:
        return None
    step = -1 if reverse else 1
    group = place.group(axis)
    dst, src = i + step, i - step
    ops, out = [], None
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def reduce_grads(grads, specs, place: Place) -> None:
    """Sum each gradient, in place, over the axes its leaf is replicated
    on (every mesh axis its spec does not name): the ranks along such an
    axis each hold the part of the gradient their own work gave.  Leaves
    with the same axes are summed in one flat f32 buffer an axis."""
    by_axes: "dict[tuple[str, ...], list[int]]" = {}
    for i, spec in enumerate(specs):
        named = spec_axes(spec)
        axes = tuple(a for a in place.sizes if a not in named and place.size(a) > 1)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        flat = torch.cat([grads[i].reshape(-1).to(torch.float32) for i in idx])
        for axis in axes:
            dist.all_reduce(flat, group=place.group(axis))
        offset = 0
        for i in idx:
            n = grads[i].numel()
            grads[i].copy_(flat[offset:offset + n].view_as(grads[i]))
            offset += n
