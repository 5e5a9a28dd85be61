"""Meshes over the ranks of an allocated slice.

Counterpart of `tpu_dra.parallel.mesh` over `torch.distributed`: one
process (rank) per device, so a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over ranks, and rank order
plays the part of the reference's device order.

- `slice_mesh`   — the physical mesh: the claim's ranks arranged by its
  topology box, indexed ``[z, y, x]`` and named (z, y, x) as the
  reference's, so each axis's process group joins the ranks along one
  dimension of the box.  Ranks are x-minor (`Topology.coords_from`).
- `logical_mesh` — the training mesh: the same ranks reshaped into named
  parallelism axes (data, fsdp, model[, expert]).

Both need a joined process group (`gang.initialize_gang`, or the workers
`validate.validate_slice` spawns) and are built by every rank of it
alike: a mesh's process groups are made collectively.  Degenerate axes
(size 1) are kept, so an axis name means the same on every slice.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_dra_torch.api.topology import Topology

__all__ = [
    "ICI_AXES", "check_topology", "logical_mesh", "mesh_shape", "slice_mesh", "topology_from_env",
]

ICI_AXES = ("x", "y", "z")


def topology_from_env(env: "dict[str, str] | None" = None) -> "Topology | None":
    """The claimed topology from the CDI-injected environment
    (``TPU_CHIPS_PER_HOST_BOUNDS``, "x,y,z"); None when the claim was a
    plain count.  A malformed value raises ValueError."""
    env = os.environ if env is None else env
    bounds = env.get("TPU_CHIPS_PER_HOST_BOUNDS")
    if not bounds:
        return None
    x, y, z = (int(p) for p in bounds.split(","))
    return Topology(x, y, z)


def mesh_shape(mesh: DeviceMesh) -> "dict[str, int]":
    """``{axis name: size}`` in the mesh's axis order (the reference's
    ``mesh.shape``); an unknown name is a KeyError."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: join one first (gang.initialize_gang, or run "
            "under validate.validate_slice's workers)"
        )
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def check_topology(topology: Topology, n: int) -> None:
    """Raise the reference's error when ``topology`` does not hold ``n``
    devices."""
    if topology.size != n:
        raise ValueError(f"topology {topology} needs {topology.size} devices, have {n}")


def slice_mesh(
    topology: "Topology | str | None" = None,
    ranks: "Sequence[int] | None" = None,
    axis_names: "tuple[str, ...]" = ICI_AXES,
) -> DeviceMesh:
    """Physical mesh over the slice's ranks.

    ``ranks`` defaults to every rank of the process group; in a gang
    they are this host's block (``host * n ... host * n + n - 1``), and
    the mesh is the host's slice of one mesh over every host, so that
    all ranks build the same process groups.  ``topology`` defaults to
    the environment's, else a line of all the ranks.  The mesh is
    indexed [z, y, x] with axes named ``(axis_names[2], axis_names[1],
    axis_names[0])``."""
    device_type = _device_type()
    world = dist.get_world_size()
    if isinstance(topology, str):
        topology = Topology.parse(topology)
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if topology is None:
        topology = topology_from_env() or Topology(len(ranks), 1, 1)
    check_topology(topology, len(ranks))
    names = (axis_names[2], axis_names[1], axis_names[0])
    shape = (topology.z, topology.y, topology.x)
    return _mesh_over(device_type, ranks, shape, names)


def _mesh_over(device_type: str, ranks: "list[int]", shape, names) -> DeviceMesh:
    """A mesh of ``shape`` over ``ranks``: every rank of the group, or one
    host's block of them (``host * n ... host * n + n - 1``), which is
    taken as the host's slice of one mesh over every host, so that all
    ranks build the same process groups."""
    world = dist.get_world_size()
    if len(ranks) == world:
        return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=names)
    n = len(ranks)
    if world % n or ranks[0] % n or ranks != list(range(ranks[0], ranks[0] + n)):
        raise ValueError(
            f"ranks {ranks} are not one host's block of {n} in a group of {world}"
        )
    root = DeviceMesh(device_type, torch.arange(world).reshape(world // n, *shape),
                      mesh_dim_names=("host", *names))
    return root[names]


def logical_mesh(
    ranks: "Sequence[int] | None" = None,
    *,
    data: int = -1,
    fsdp: int = 1,
    model: int = 1,
    expert: "int | None" = None,
) -> DeviceMesh:
    """Logical training mesh with (data, fsdp, model[, expert]) axes over
    ``ranks`` (default: every rank of the process group; in a gang, this
    host's block of them, as `slice_mesh` takes it).

    One axis may be -1 (inferred).  Rank order is kept, so the innermost
    axis joins the nearest ranks; ``expert`` (when given) appends a
    dedicated MoE axis innermost.  The sizes are validated with the
    reference's messages before any process group is touched."""
    if ranks is None:
        ranks = list(range(dist.get_world_size())) if dist.is_initialized() else [0]
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    sizes = {"data": data, "fsdp": fsdp, "model": model}
    if expert is not None:
        sizes["expert"] = expert
    for name, v in sizes.items():
        if v != -1 and v < 1:
            raise ValueError(f"axis {name!r} size must be -1 (inferred) or >= 1, got {v}")
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis size may be -1")
    known = 1
    for k, v in sizes.items():
        if v != -1:
            known *= v
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    elif known != n:
        raise ValueError(f"mesh {sizes} needs {known} devices, have {n}")
    return _mesh_over(_device_type(), ranks, tuple(sizes.values()), tuple(sizes))
