"""Host swap tier for the paged KV pool.

Counterpart of `tpu_dra.parallel.swap`, host-side bookkeeping only (the
block copies are `paged.read_block` / `paged.write_block`, the wiring is
`serve.ServeEngine`):

- `HostBlockPool`: a bounded pool of host slots, each holding one
  device block's payload (what `read_block` returns, copied to pinned
  host memory on a CUDA engine; bf16 or the int8 ``{"q","s"}`` pair —
  the pool never inspects it), with a free list and exclusive slot
  ownership.  Capacity is the engine's ``host_kv_blocks``; a full pool
  means preemption is unavailable and admission parks instead.
- `AgeHeatPolicy` (the default `VictimPolicy`): picks the swap-out
  victim among preemptible rows from the allocator's block records
  (`BlockAllocator.block_records`): score = mean block age x idleness,
  scaled up when releasing the row's exclusively held blocks would
  lengthen the longest contiguous free run.  Anything with the same
  ``pick`` signature serves (``ServeEngine(swap_policy=...)``).

The engine preempts only a row whose request has STRICTLY lower priority
than the waiting head (equal priorities park, never thrash), and only
after the block-granular LRU trim of unpinned prefix entries came up
short.
"""

from __future__ import annotations

__all__ = ["AgeHeatPolicy", "HostBlockPool", "VictimPolicy"]


class HostBlockPool:
    """Bounded host-side block slots with exclusive ownership.

    ``store`` claims a free slot for one device block's fetched tree and
    returns the slot id; ``load`` reads it back (the payload is returned
    exactly as stored — the read_block/write_block round trip is what
    makes swap token-identical); ``free`` releases the slot.  The pool
    allocates lazily — capacity bounds the slot COUNT, memory is only
    held for blocks actually resident on host."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(
                f"host pool capacity must be >= 0, got {capacity}"
            )
        self.capacity = capacity
        self._data: "dict[int, object]" = {}
        # LIFO free list, low ids first out — deterministic for tests,
        # like the device allocator's.
        self._free = list(range(capacity - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.capacity - len(self._free)

    def used_slots(self) -> "list[int]":
        """Currently owned slot ids (sorted) — the conservation check's
        view."""
        return sorted(self._data)

    def store(self, data) -> "int | None":
        """Claim a slot for ``data``; None (and nothing stored) when the
        pool is full — the caller then parks instead of preempting."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._data[slot] = data
        return slot

    def load(self, slot: int):
        """The stored payload of an owned slot (the slot stays owned —
        callers `free` it once the swap-in write landed)."""
        if slot not in self._data:
            raise RuntimeError(f"load of unowned host slot {slot}")
        return self._data[slot]

    def free(self, slot: int) -> None:
        if slot not in self._data:
            raise RuntimeError(f"free of unowned host slot {slot}")
        del self._data[slot]
        self._free.append(slot)

    def stats(self) -> "dict[str, int]":
        return {
            "host_capacity": self.capacity,
            "host_used": self.used_count,
            "host_free": self.free_count,
        }


class VictimPolicy:
    """The swap-victim selection protocol (``ServeEngine(swap_policy=)``).

    ``pick`` receives one candidate dict per preemptible row —
    ``{"row", "priority", "blocks", "records"}`` where ``records`` maps
    each of the row's block ids to its `BlockAllocator.block_records`
    entry (refcount/origin/idle_steps/age_s) — plus the pool's current
    free-block id set and total size, and returns the chosen candidate's
    ``row`` (or None to decline, which parks the head instead).  The
    engine has already filtered candidates by priority (strictly below
    the waiting request's) and by host-pool capacity; policies only
    rank.  Implementations must be host-only and allocation-light — this
    runs on the admission path, though only when the pool is already
    exhausted."""

    def pick(self, candidates: "list[dict]", *, free_blocks: "set[int]",
             num_blocks: int) -> "int | None":
        raise NotImplementedError


class AgeHeatPolicy(VictimPolicy):
    """Default victim policy: age x heat, defrag-aware.

    Per candidate row: ``cold = mean(age_s * (1 + idle_steps))`` over
    its blocks — a row that is both long-resident AND long-untouched
    scores high (a stalled background decode), a young or hot row low.
    The score is then scaled by the contiguity gain: simulate returning
    the row's exclusively-held (refcount 1) blocks to the free list and
    measure how much the LONGEST contiguous free run grows (the runs of
    `BlockAllocator.free_runs`).  ``defrag_weight`` sets how strongly
    run-knitting outranks pure coldness (0 = ignore layout)."""

    def __init__(self, defrag_weight: float = 1.0):
        if defrag_weight < 0:
            raise ValueError(
                f"defrag_weight must be >= 0, got {defrag_weight}"
            )
        self.defrag_weight = defrag_weight

    @staticmethod
    def _longest_run(free: "set[int]", num_blocks: int) -> int:
        longest = run = 0
        for b in range(1, num_blocks):  # block 0 is scratch, never free
            if b in free:
                run += 1
                longest = max(longest, run)
            else:
                run = 0
        return longest

    def pick(self, candidates: "list[dict]", *, free_blocks: "set[int]",
             num_blocks: int) -> "int | None":
        if not candidates:
            return None
        base_run = self._longest_run(free_blocks, num_blocks)
        best_row = None
        best_score = None
        for cand in candidates:
            recs = cand["records"]
            ages = [
                recs[b]["age_s"] * (1.0 + recs[b]["idle_steps"])
                for b in cand["blocks"]
                if b in recs
            ]
            cold = sum(ages) / len(ages) if ages else 0.0
            released = free_blocks | {
                b
                for b in cand["blocks"]
                if b in recs and recs[b]["refcount"] == 1
            }
            gain = self._longest_run(released, num_blocks) - base_run
            score = (cold + 1e-9) * (
                1.0 + self.defrag_weight * gain / max(1, num_blocks)
            )
            # Deterministic tie-break: lowest row index wins at equal
            # score, so tests and replays are stable.
            if best_score is None or score > best_score:
                best_row, best_score = cand["row"], score
        return best_row
