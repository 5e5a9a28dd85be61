"""Prefix digests: the summary of one replica's KV residency a fleet
router matches prompts against.

Counterpart of `tpu_dra.fleet.digest`, hashing byte for byte as it does,
so a router can hold digests of port and reference replicas side by
side.  For every resident token run, the run's window-aligned prefixes
(the granularity at which the engine can skip prefill work) are hashed
to 8 bytes each and stored as ``hash -> hits``.  Lookup hashes a
prompt's window-aligned prefixes longest first and returns the first
resident length.  A digest holds no token runs, carries the prefix
cache's residency epoch at build time (a holder refreshes when the
engine's epoch moved), and can only claim prefixes that were resident
when it was built: a stale claim is caught by the router's live check
(`ServeEngine.peek_prefix`).

Built from `ServeEngine.export_prefix_index()` by
`ServeEngine.prefix_digest()`.  Plain Python: no torch.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

__all__ = ["ReplicaDigest", "build_digest", "empty_digest", "hash_run"]


def hash_run(tokens: "list[int]") -> str:
    """Stable 8-byte digest of a token run, in hex: blake2b over the ids
    as comma-joined decimals, so distinct runs never alias by
    concatenation."""
    data = b",".join(b"%d" % t for t in tokens)
    return hashlib.blake2b(data, digest_size=8).hexdigest()


@dataclass
class ReplicaDigest:
    """One replica's resident-prefix summary at a point in time.

    ``prefixes`` maps ``hash_run(tokens[:k * window]) -> hits`` for every
    resident run and every window multiple k; ``max_len`` bounds the
    longest claimable prefix; ``epoch`` is the cache's residency epoch at
    build time; ``built_at`` is on the monotonic clock, so a step of the
    wall clock cannot make a digest look fresh or old."""

    replica: str
    window: int = 1
    epoch: int = 0
    built_at: float = 0.0
    max_len: int = 0
    prefixes: "dict[str, int]" = field(default_factory=dict)

    @property
    def entries(self) -> int:
        return len(self.prefixes)

    def age_s(self, now: "float | None" = None) -> float:
        """Seconds since build; ``now``, when given, must come from
        ``time.monotonic()``, like ``built_at``."""
        return max(0.0, (time.monotonic() if now is None else now) - self.built_at)

    def lookup(self, tokens: "list[int]") -> "tuple[int, int]":
        """Longest window-aligned prefix of ``tokens`` this digest claims
        resident: ``(matched_len, hits)``, ``(0, 0)`` when none does.  The
        engine always computes a prompt's last position, so a match is
        capped at ``len(tokens) - 1``, as the cache caps it."""
        if self.window < 1 or self.max_len < 1:
            return 0, 0
        limit = min(len(tokens) - 1, self.max_len)
        for k in range(limit // self.window, 0, -1):
            hits = self.prefixes.get(hash_run(tokens[: k * self.window]))
            if hits is not None:
                return k * self.window, hits
        return 0, 0

    def to_dict(self) -> dict:
        """JSON-able identity and sizes (not the hash table)."""
        return {
            "replica": self.replica,
            "window": self.window,
            "epoch": self.epoch,
            "built_at": self.built_at,
            "age_s": round(self.age_s(), 3),
            "entries": self.entries,
            "max_len": self.max_len,
        }


def empty_digest(replica: str) -> ReplicaDigest:
    """The digest of an engine with no prefix cache: it matches nothing,
    so the replica is placed by load alone."""
    return ReplicaDigest(replica=replica, window=1, built_at=time.monotonic())


def build_digest(index: dict, *, replica: str, epoch: int = 0,
                 window: "int | None" = None) -> ReplicaDigest:
    """Digest an exported prefix index (``{"prefix_window": W, "entries":
    [{"tokens", "hits"}, ...]}``).  Every run gives all its window-aligned
    prefixes; a prefix several runs share keeps the hottest run's hits."""
    if window is None:
        window = index.get("prefix_window") or 1
    window = int(window)
    if window < 1:
        raise ValueError(f"digest window must be >= 1, got {window}")
    prefixes: "dict[str, int]" = {}
    max_len = 0
    for entry in index.get("entries") or ():
        tokens = entry.get("tokens") or []
        hits = int(entry.get("hits", 0))
        aligned = (len(tokens) // window) * window
        for k in range(1, aligned // window + 1):
            h = hash_run(tokens[: k * window])
            if hits > prefixes.get(h, -1):
                prefixes[h] = hits
        max_len = max(max_len, aligned)
    return ReplicaDigest(
        replica=replica, window=window, epoch=epoch,
        built_at=time.monotonic(), max_len=max_len, prefixes=prefixes,
    )
