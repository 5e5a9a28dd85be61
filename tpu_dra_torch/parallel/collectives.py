"""Collective correctness checks and all-reduce bandwidth over a slice.

Counterpart of `tpu_dra.parallel.collectives` over `torch.distributed`
(NCCL between cards, gloo between CPU processes): the reference's
``shard_map`` of ``psum`` / ``all_gather`` / ``ppermute`` over one mesh
axis becomes the matching collective over that axis's process group,
run by every rank of the mesh.  Each rank checks its own shard against
the value the reference's global result holds there, and a rank's
report is its own: `validate.validate_slice` joins the ranks' reports.

Bandwidth accounting is the reference's ring all-reduce bus bandwidth:
each rank sends and receives ``2 (n-1)/n * bytes``, so

    busbw = 2 * (n-1)/n * bytes / time

comparable across slice sizes.  Every check reports, never raises.
"""

from __future__ import annotations

import statistics
import time
import warnings
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_dra_torch.parallel.mesh import mesh_shape

__all__ = [
    "CollectiveReport",
    "all_gather_check",
    "hierarchical_psum",
    "hierarchical_psum_check",
    "psum_bandwidth",
    "psum_check",
    "ring_check",
    "timed_allreduce_report",
]


@dataclass
class CollectiveReport:
    """Result of one collective measurement on a mesh axis."""

    op: str
    axis: str
    n_devices: int
    ok: bool
    bytes_per_device: int = 0
    seconds_p50: float = 0.0
    busbw_gbps: float = 0.0
    error: str = ""
    samples: "list[float]" = field(default_factory=list)


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its card under NCCL, the
    CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _shard(x, mesh: DeviceMesh, axis: str, n: int):
    """This rank's shard of ``x`` split n ways along dim 0 by its place
    on ``axis`` (the reference's ``P(axis)``), on the rank's device."""
    i = mesh.get_local_rank(axis)
    chunk = x.shape[0] // n
    return x[i * chunk:(i + 1) * chunk].to(rank_device(mesh)).clone()


def psum_check(mesh: DeviceMesh, axis: str) -> CollectiveReport:
    """All-reduce correctness: shard i holds ``arange(n * 4)[4i:4i+4]``;
    after the all-reduce every shard is the sum of all shards."""
    n = mesh_shape(mesh)[axis]
    try:
        chunk = 4
        ranks = torch.arange(n * chunk, dtype=torch.float32)
        x = _shard(ranks, mesh, axis, n)
        dist.all_reduce(x, group=mesh.get_group(axis))
        expected = ranks.reshape(n, chunk).sum(dim=0)
        ok = bool(torch.allclose(x.cpu(), expected))
        return CollectiveReport(op="psum", axis=axis, n_devices=n, ok=ok)
    except Exception as e:  # surfaced in the report, not raised: burn-in must finish
        return CollectiveReport(op="psum", axis=axis, n_devices=n, ok=False, error=str(e))


def all_gather_check(mesh: DeviceMesh, axis: str) -> CollectiveReport:
    """all_gather correctness: every rank ends with every shard, i.e.
    the whole ``arange(n * 4)``."""
    n = mesh_shape(mesh)[axis]
    try:
        x = torch.arange(n * 4, dtype=torch.float32)
        shard = _shard(x, mesh, axis, n)
        out = torch.empty((n * 4,), dtype=torch.float32, device=shard.device)
        dist.all_gather_into_tensor(out, shard, group=mesh.get_group(axis))
        ok = bool(torch.allclose(out.cpu(), x))
        return CollectiveReport(op="all_gather", axis=axis, n_devices=n, ok=ok)
    except Exception as e:
        return CollectiveReport(op="all_gather", axis=axis, n_devices=n, ok=False, error=str(e))


def _shift(x, group, n: int, i: int):
    """One hop of the ring: send ``x`` to place i+1, receive from i-1."""
    out = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (i + 1) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - 1) % n), group),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def ring_check(mesh: DeviceMesh, axis: str) -> CollectiveReport:
    """Point-to-point ring: shift-by-one along the axis, n times, must
    give back each rank's own value.  Exercises every neighbour link on
    its own — a broken link an all-reduce could route around still
    fails here."""
    n = mesh_shape(mesh)[axis]
    try:
        x = torch.arange(max(n, 1), dtype=torch.float32)
        shard = _shard(x, mesh, axis, max(n, 1))
        out = shard
        if n > 1:  # one place: the ring is the identity
            group, i = mesh.get_group(axis), mesh.get_local_rank(axis)
            for _ in range(n):
                out = _shift(out, group, n, i)
        ok = bool(torch.equal(out.cpu(), shard.cpu()))
        return CollectiveReport(op="ppermute_ring", axis=axis, n_devices=n, ok=ok)
    except Exception as e:
        return CollectiveReport(op="ppermute_ring", axis=axis, n_devices=n, ok=False,
                                error=str(e))


def hierarchical_psum(x, mesh: DeviceMesh, ici_axis: str, dcn_axis: str):
    """Two-level all-reduce of this rank's ``x`` over a mesh carrying both
    axes: reduce-scatter over ``ici_axis`` (the fast inner links), an
    all-reduce of the scattered chunk over ``dcn_axis`` with 1/n_ici of
    the bytes crossing the slow outer links, then an all-gather back over
    ``ici_axis``.  Equal to one all-reduce over both axes; ``x``'s leading
    dim must divide by the ``ici_axis`` size.  Returns a new tensor."""
    n_ici = mesh_shape(mesh)[ici_axis]
    ici = mesh.get_group(ici_axis)
    chunk = torch.empty((x.shape[0] // n_ici, *x.shape[1:]), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # Newer torch renames it reduce_scatter_single; older has only this name.
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(chunk, x.contiguous(), group=ici)
    dist.all_reduce(chunk, group=mesh.get_group(dcn_axis))
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, chunk, group=ici)
    return out


def hierarchical_psum_check(mesh: DeviceMesh, ici_axis: str, dcn_axis: str) -> CollectiveReport:
    """`hierarchical_psum` against the all-reduce over both axes (an
    all-reduce over each in turn: the same sum), on shards of n_ici
    elements, so the reduce-scatter splits one element per inner place.
    The reduce-scatter is an explicit call here, not a compiler's choice,
    so the reference's check of the compiled program has nothing to
    check."""
    n = 0
    try:  # incl. the axis lookups: a bad name is a report, not a crash
        shape = mesh_shape(mesh)
        n_ici, n_dcn = shape[ici_axis], shape[dcn_axis]
        n = n_ici * n_dcn
        x = torch.arange(n * n_ici, dtype=torch.float32)
        # The shard of the reference's P((dcn, ici)): dcn-major places.
        s = mesh.get_local_rank(dcn_axis) * n_ici + mesh.get_local_rank(ici_axis)
        shard = x[s * n_ici:(s + 1) * n_ici].to(rank_device(mesh))
        got = hierarchical_psum(shard, mesh, ici_axis, dcn_axis)
        want = shard.clone()
        dist.all_reduce(want, group=mesh.get_group(ici_axis))
        dist.all_reduce(want, group=mesh.get_group(dcn_axis))
        ok = bool(torch.allclose(got.cpu(), want.cpu()))
        return CollectiveReport(op="hierarchical_psum", axis=f"{ici_axis}x{dcn_axis}",
                                n_devices=n, ok=ok, error="" if ok else "mismatch vs flat psum")
    except Exception as e:
        return CollectiveReport(op="hierarchical_psum", axis=f"{ici_axis}x{dcn_axis}",
                                n_devices=n, ok=False, error=str(e))


def timed_allreduce_report(op: str, axis_label: str, n: int, fn, x, nbytes: int, *,
                           iters: int = 10, warmup: int = 2) -> CollectiveReport:
    """Shared timing scaffold for all-reduce-shaped measurements: warm
    runs, the median of timed runs, each waiting for the device, and the
    ring all-reduce bus bandwidth (module docstring), so that every
    caller's number is computed the same way."""

    def run():
        fn(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    for _ in range(max(1, warmup)):
        run()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        samples.append(time.perf_counter() - t0)
    p50 = statistics.median(samples)
    busbw = (2 * (n - 1) / n) * nbytes / p50 / 1e9 if n > 1 and p50 > 0 else 0.0
    return CollectiveReport(op=op, axis=axis_label, n_devices=n, ok=True, bytes_per_device=nbytes,
                            seconds_p50=p50, busbw_gbps=busbw, samples=samples)


def psum_bandwidth(mesh: DeviceMesh, axis: str, *, mbytes: int = 64, iters: int = 10,
                   warmup: int = 2, dtype=torch.float32) -> CollectiveReport:
    """All-reduce bus bandwidth along one mesh axis: ``mbytes`` MiB a
    rank, all-reduced in place over the axis's group, the median of
    ``iters`` timed runs after ``warmup`` runs."""
    n = mesh_shape(mesh)[axis]
    itemsize = torch.empty((), dtype=dtype).element_size()
    elems = max(1, mbytes * (1024**2) // itemsize)
    nbytes = elems * itemsize
    try:
        group = mesh.get_group(axis)
        x = torch.ones((elems,), dtype=dtype, device=rank_device(mesh))
        return timed_allreduce_report(
            "psum_bandwidth", axis, n, lambda v: dist.all_reduce(v, group=group), x, nbytes,
            iters=iters, warmup=warmup,
        )
    except Exception as e:
        return CollectiveReport(op="psum_bandwidth", axis=axis, n_devices=n, ok=False,
                                error=str(e))
