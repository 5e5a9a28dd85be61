"""Multi-host gang assembly for DRA-allocated slices, over
`torch.distributed`.

Counterpart of `tpu_dra.parallel.gang`.  The driver's CDI layer injects
the coordination contract into each gang member (`tpu_dra/plugin/cdi.py`'s
gang edits, which the port reads and does not own):

- ``TPU_DRA_GANG_COORDINATOR`` — host:port of process 0
- ``TPU_DRA_GANG_SIZE``        — number of processes (pods) in the gang
- ``TPU_DRA_GANG_RANK``        — this pod's process index

The one difference from the reference: PyTorch drives one device from
one process, so a pod with ``n_local`` devices runs ``n_local`` ranks
and the gang's process group has ``size * n_local`` of them; the pod of
gang rank g holds ranks ``g * n_local ... g * n_local + n_local - 1``.
The coordinator's address is where rank 0 serves the group's store.
"""

from __future__ import annotations

import collections
import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_dra_torch.parallel.collectives import (
    CollectiveReport,
    hierarchical_psum,
    psum_bandwidth,
    rank_device,
    timed_allreduce_report,
)
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.mesh import logical_mesh

__all__ = [
    "ENV_COORDINATOR",
    "ENV_RANK",
    "ENV_SIZE",
    "GROUP_TIMEOUT_S",
    "GangEnv",
    "barrier",
    "gang_allreduce",
    "hierarchical_allreduce_bandwidth",
    "initialize_gang",
    "join_group",
]

ENV_COORDINATOR = "TPU_DRA_GANG_COORDINATOR"
ENV_SIZE = "TPU_DRA_GANG_SIZE"
ENV_RANK = "TPU_DRA_GANG_RANK"
# How long a rank waits for the others at the rendezvous and in any
# collective before the group gives up on them.
GROUP_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class GangEnv:
    """Gang coordination contract as injected by the driver."""

    coordinator: str
    size: int
    rank: int

    @classmethod
    def from_env(cls, env: "dict[str, str] | None" = None) -> "GangEnv | None":
        env = os.environ if env is None else env
        coordinator = env.get(ENV_COORDINATOR)
        if not coordinator:
            return None
        return cls(
            coordinator=coordinator,
            size=int(env.get(ENV_SIZE, "1")),
            rank=int(env.get(ENV_RANK, "0")),
        )

    def as_env(self) -> "dict[str, str]":
        return {
            ENV_COORDINATOR: self.coordinator,
            ENV_SIZE: str(self.size),
            ENV_RANK: str(self.rank),
        }


def join_group(init_method: str, *, world_size: int, rank: int,
               device: "str | torch.device" = "cuda",
               timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join a process group of ``world_size`` ranks as ``rank``: NCCL when
    ``device`` is a card (made this process's current device first), gloo
    on the CPU.  ``init_method`` is the rendezvous, ``tcp://host:port``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )


def initialize_gang(gang: "GangEnv | None" = None, *, local_rank: int = 0, n_local: int = 1,
                    device: "str | torch.device" = "cuda",
                    timeout_s: float = GROUP_TIMEOUT_S) -> "GangEnv | None":
    """Join the gang's process group (idempotent; a no-op when solo).

    This process is local rank ``local_rank`` of the pod's ``n_local``
    ranks.  Returns the GangEnv used, or None when there is no gang (no
    gang env, or a gang of one)."""
    if gang is None:
        gang = GangEnv.from_env()
    if gang is None or gang.size <= 1:
        return None
    if not dist.is_initialized():
        join_group(f"tcp://{gang.coordinator}", world_size=gang.size * n_local,
                   rank=gang.rank * n_local + local_rank, device=device, timeout_s=timeout_s)
    return gang


def gang_allreduce(mbytes: int = 16, *, host: int = 0):
    """An all-reduce across every rank of every gang member: the global
    acceptance check.  ``host`` is this rank's gang rank.  A group
    spanning several hosts reduces with the two-level
    `hierarchical_allreduce_bandwidth`, so the cross-host hop carries
    1/n_local of the bytes by construction; one host reduces flat over
    one axis.  Every rank of the group calls it."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, host)
    if len(set(hosts)) > 1:
        return hierarchical_allreduce_bandwidth(mbytes=mbytes, hosts=hosts)
    mesh = logical_mesh(data=-1, fsdp=1, model=1)
    return psum_bandwidth(mesh, "data", mbytes=mbytes)


def hierarchical_allreduce_bandwidth(mbytes: int = 16, iters: int = 10, warmup: int = 2, *,
                                     hosts: "list[int]"):
    """Timed two-level all-reduce over the gang's (dcn, ici) mesh, where
    ``hosts[r]`` is rank r's host.  The mesh rows are the ranks grouped
    by host (sorted by (host, rank)), so the "ici" axis never crosses a
    host; unequal rank counts per host (a degraded member) are reported
    as a failure, not reshaped around.  Timing and bus bandwidth come
    from `timed_allreduce_report`, as `psum_bandwidth`'s do."""
    n = len(hosts)
    try:
        counts = collections.Counter(hosts)
        n_hosts = len(counts)
        if len(set(counts.values())) != 1:
            return CollectiveReport(
                op="hierarchical_allreduce", axis="icixdcn", n_devices=n, ok=False,
                error=f"unequal local device counts per host: {dict(sorted(counts.items()))}",
            )
        n_local = n // n_hosts
        order = sorted(range(n), key=lambda r: (hosts[r], r))
        mesh = DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                          torch.tensor(order).reshape(n_hosts, n_local),
                          mesh_dim_names=("dcn", "ici"))
        elems = max(n_local, mbytes * (1024**2) // 4 // n_local * n_local)
        x = torch.ones((elems,), dtype=torch.float32, device=rank_device(mesh))
        return timed_allreduce_report(
            "hierarchical_allreduce", f"ici[{n_local}]xdcn[{n_hosts}]", n,
            lambda v: hierarchical_psum(v, mesh, "ici", "dcn"), x, elems * 4,
            iters=iters, warmup=warmup,
        )
    except Exception as e:
        return CollectiveReport(op="hierarchical_allreduce", axis="icixdcn", n_devices=n,
                                ok=False, error=str(e))


def barrier() -> None:
    """Cross-rank barrier: a tiny all-reduce over the whole group, waited
    for on the host."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    x = torch.ones((1,), dtype=torch.float32, device=device)
    dist.all_reduce(x)
    float(x[0])
