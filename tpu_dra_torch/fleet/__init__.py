"""The serving fleet of the port: N `ServeEngine` replicas as one system.

Counterpart of `tpu_dra.fleet`, at mirrored paths:

- ``digest``: the prefix digest a replica publishes;
- ``router``: `PrefixRouter`, placement by the longest resident prefix,
  shed past a load skew, with goodput-aware load;
- ``fleet``: `ServeFleet`, the replicas behind one front door (queue,
  digest refresh and spill, threaded ticks, `scale_hint`);
- ``stats``: the placement flight recorder behind ``/debug/fleet``.

``digest``, ``router`` and ``stats`` are plain Python; only ``fleet``
touches engines.  The names below resolve on attribute access (PEP 562),
so ``import tpu_dra_torch.fleet.stats`` does not import the engine.
"""

from __future__ import annotations

__all__ = ["PrefixRouter", "ReplicaDigest", "ServeFleet"]


def __getattr__(name: str):
    if name == "ServeFleet":
        from tpu_dra_torch.fleet.fleet import ServeFleet

        return ServeFleet
    if name == "PrefixRouter":
        from tpu_dra_torch.fleet.router import PrefixRouter

        return PrefixRouter
    if name == "ReplicaDigest":
        from tpu_dra_torch.fleet.digest import ReplicaDigest

        return ReplicaDigest
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
