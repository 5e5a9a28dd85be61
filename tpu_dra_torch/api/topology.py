"""Topology boxes of a claimed slice: the port's own copy of the part of
`tpu_dra.api.topology` that `mesh` and `validate` read.

A multi-device claim is a ``Topology`` box (``XxYxZ``, e.g. ``2x2x1``);
the devices of a claim are numbered x-minor, which `mesh.slice_mesh`
turns into rank order.  Parsing, sizes, coordinates and every error
message are the reference's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator

__all__ = ["Coord", "Topology"]

Coord = tuple[int, int, int]


@dataclass(frozen=True)
class Topology:
    """An axis-aligned box of devices, e.g. 2x2x1 (canonical form "XxYxZ")."""

    x: int
    y: int
    z: int = 1

    _TOPOLOGY_RE = re.compile(r"^(\d+)x(\d+)(?:x(\d+))?$")

    @classmethod
    def parse(cls, text: str) -> "Topology":
        m = cls._TOPOLOGY_RE.match(text.strip())
        if not m:
            raise ValueError(f"invalid topology {text!r} (expected e.g. '2x2x1')")
        x, y = int(m.group(1)), int(m.group(2))
        z = int(m.group(3)) if m.group(3) else 1
        if x < 1 or y < 1 or z < 1:
            raise ValueError(f"invalid topology {text!r}: dims must be >= 1")
        return cls(x, y, z)

    @property
    def size(self) -> int:
        return self.x * self.y * self.z

    def dims(self) -> tuple[int, int, int]:
        return (self.x, self.y, self.z)

    def coords_from(self, origin: Coord) -> Iterator[Coord]:
        """All coordinates of this box placed with its min-corner at
        ``origin``, x-minor (x fastest): the order of the claim's devices,
        and so of the ranks along a mesh over the slice."""
        ox, oy, oz = origin
        for dz in range(self.z):
            for dy in range(self.y):
                for dx in range(self.x):
                    yield (ox + dx, oy + dy, oz + dz)

    def __str__(self) -> str:
        return f"{self.x}x{self.y}x{self.z}"
