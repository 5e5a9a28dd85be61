"""Shared-prefix KV reuse for the serving engine.

Counterpart of `tpu_dra.parallel.prefixcache`.  A path-compressed radix
index over the token runs of admitted prompts finds the longest resident
prefix of a new prompt (causal KV at position j depends only on tokens
[0, j], so a resident run serves any prompt sharing its first tokens).
Entries a mid-decode row reads or wrote are pinned; among unpinned ones
the least recently used goes first.  Two storage forms share the index:

- `PagedPrefixCache` (the paged layout): entries hold refcounted
  BLOCK-ID LISTS into the engine's one block pool
  (`paged.BlockAllocator`), so a hit is a zero-copy alias of the
  window-aligned prefix blocks into the new request's block table, and
  parking a prompt is free (the entry refs the blocks its admission just
  wrote).  Eviction under block pressure trims the coldest tail block
  first (entries shrink before they die), and the resident-entry cap
  evicts whole entries.
- `PrefixCache` (the rows layout): a device pool of ``pool_slots`` cache
  rows (one `decode.init_cache`), each holding one entry's positions; a
  hit is a device copy of the prefix into the admitted row
  (`decode.copy_prefix_into_row`), parking a prompt a copy back.  On a
  mesh the pool holds the rank's heads of every row (the admission
  prefill it copies from is replicated over data x fsdp); the paged
  cache needs nothing more than the pool's layout
  (`paged.block_pool_spec`).

The hit/miss/eviction counts are instance fields (``stats()``) and move
the process's ``tpu_dra_serve_prefix_{hits,misses,evictions}_total``
counters at the reference's sites.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.decode import _kv_cache, _local_heads, init_cache
from tpu_dra_torch.utils.metrics import (
    SERVE_PREFIX_EVICTIONS,
    SERVE_PREFIX_HITS,
    SERVE_PREFIX_MISSES,
)

__all__ = ["PagedPrefixCache", "PrefixCache", "PrefixEntry"]


class _Node:
    """One radix-tree node: ``edge`` is the token run from the parent,
    ``children`` keys on the first token of each child edge (token runs
    are path-compressed), ``entry`` is the resident pool segment for the
    prefix ending exactly here (terminals; splits create pass-through
    nodes with no entry)."""

    __slots__ = ("edge", "children", "entry", "parent")

    def __init__(self, edge: "list[int]", parent: "_Node | None"):
        self.edge = edge
        self.children: "dict[int, _Node]" = {}
        self.entry: "PrefixEntry | None" = None
        self.parent = parent


@dataclass
class PrefixEntry:
    """A resident prefix segment: valid KV for cache positions
    ``[0, length)``, stored in pool row ``slot`` (row-backed) or in the
    block-id list ``blocks`` (paged: ``slot`` is -1 and each listed block
    carries one allocator reference held by this entry).  ``refcount > 0`` pins the
    entry against eviction (held by every engine row whose admission
    read or wrote it, released when the request finishes).  ``hits``
    counts lookups this entry served."""

    slot: int
    length: int
    refcount: int = 0
    last_used: int = 0
    hits: int = 0
    node: "_Node | None" = field(default=None, repr=False)
    blocks: "list[int] | None" = None


class _RadixIndex:
    """The storage-agnostic radix index: walk/match/peek semantics, the
    pin lifecycle, LRU victim selection and tree surgery.  The subclass
    owns storage (block references into the paged pool)."""

    def __init__(self):
        self._root = _Node([], None)
        self._entries: "list[PrefixEntry]" = []
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Residency epoch: bumped whenever the SET of resident prefixes
        # changes (insert / eviction).  A consumer holding a derived view
        # of the index — the fleet router's prefix digest — compares
        # epochs to know its view is stale without diffing token runs.
        self.epoch = 0

    # -- lookup ----------------------------------------------------------
    def _walk(self, tokens: "list[int]"):
        """Deepest reach of ``tokens`` in the tree: returns
        ``(node, matched)`` where ``matched`` tokens are shared with every
        entry in ``node``'s subtree (``node`` may be only partially
        entered — its edge matched past ``matched - depth(parent)``
        tokens, which still bounds the shared run from below)."""
        node, depth = self._root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                return node, depth
            common = 0
            rest = tokens[depth:]
            for a, b in zip(child.edge, rest):
                if a != b:
                    break
                common += 1
            depth += common
            if common < len(child.edge):
                # Diverged mid-edge: everything below `child` still
                # shares the first `depth` tokens.
                return child, depth
            node = child
        return node, depth

    def _best_in_subtree(self, node: "_Node") -> "PrefixEntry | None":
        """Hottest resident entry at or below ``node`` (any one is
        usable at the matched length; most-recently-used keeps the walk
        aligned with the LRU policy).  Pools are small, DFS is cheap."""
        best = node.entry
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.entry is not None and (
                best is None or n.entry.last_used > best.last_used
            ):
                best = n.entry
            stack.extend(n.children.values())
        return best

    def match(self, tokens: "list[int]", min_use: int = 1):
        """Longest usable resident prefix of ``tokens``: returns
        ``(entry, use_len, matched_raw)``.  ``use_len`` is capped at
        ``len(tokens) - 1`` — the engine must always compute at least the
        last prompt position (first-token logits come from compute, not
        storage).  ``matched_raw`` is the uncapped overlap, so the caller
        can tell "this exact prompt is already resident"
        (``matched_raw >= len(tokens)``) and skip a duplicate insert.
        ``min_use``: matches shorter than this count as misses (the
        engine passes its suffix-window width — a sub-window match saves
        no compute, so treating it as a hit would only add copy traffic).
        Counts one hit or miss."""
        node, matched = self._walk(tokens)
        use = min(matched, len(tokens) - 1)
        entry = None
        if use > 0:
            # A matched non-root node always has a resident entry in its
            # subtree: _detach prunes entry-less childless chains on
            # every eviction, and inserts build path + entry atomically
            # — so this lookup cannot come back empty for use > 0 (the
            # None guard below is belt-and-braces, not a reachable
            # fallback).
            entry = self._best_in_subtree(node)
            if entry is not None:
                use = min(use, entry.length)
        if entry is None or use < max(1, min_use):
            self.misses += 1
            SERVE_PREFIX_MISSES.inc()
            return None, 0, matched
        self.hits += 1
        entry.hits += 1
        SERVE_PREFIX_HITS.inc()
        # A hit is a use: refresh recency so the LRU victim is the entry
        # no lookup has touched longest, not merely the oldest insert.
        self._tick += 1
        entry.last_used = self._tick
        return entry, use, matched

    def peek(self, tokens: "list[int]", min_use: int = 1) -> int:
        """`match` as a pure question: the usable resident-prefix length
        of ``tokens`` (0 when it would miss) WITHOUT moving hit/miss
        counters, hotness, or recency.  The fleet router's staleness
        probe — and the paged engine's admission-control estimator (the
        block demand a hit would save must be known before deciding the
        request fits)."""
        node, matched = self._walk(tokens)
        use = min(matched, len(tokens) - 1)
        if use <= 0:
            return 0
        entry = self._best_in_subtree(node)
        if entry is None:
            return 0
        use = min(use, entry.length)
        return use if use >= max(1, min_use) else 0

    # -- pinning ---------------------------------------------------------
    def acquire(self, entry: PrefixEntry) -> None:
        entry.refcount += 1
        self._tick += 1
        entry.last_used = self._tick

    def release(self, entry: PrefixEntry) -> None:
        if entry.refcount <= 0:
            raise RuntimeError("release without matching acquire")
        entry.refcount -= 1

    # -- eviction / tree surgery -----------------------------------------
    def _pick_victim(self) -> "PrefixEntry | None":
        victims = [e for e in self._entries if e.refcount == 0]
        if not victims:
            return None
        return min(victims, key=lambda e: e.last_used)

    def _detach(self, entry: PrefixEntry) -> None:
        node = entry.node
        entry.node = None
        node.entry = None
        self._entries.remove(entry)
        # Prune now-useless leaves so the index stays proportional to
        # resident entries, not to everything ever admitted.
        while (
            node is not None
            and node.parent is not None
            and node.entry is None
            and not node.children
        ):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    # -- insertion helpers -----------------------------------------------
    def _exact_resident(self, tokens: "list[int]") -> "PrefixEntry | None":
        """The entry indexing EXACTLY ``tokens``, if resident (callers
        normally skip duplicates via matched_raw, but a capped match can
        land here when the terminal's own run was what matched)."""
        node, depth = self._walk(tokens)
        if (
            depth == len(tokens)
            and depth == self._node_depth(node)
            and node.entry is not None
        ):
            return node.entry
        return None

    def _attach(self, tokens: "list[int]") -> "_Node":
        """Build (or reuse) the terminal node for ``tokens``, splitting
        edges as needed.  Walks the CURRENT tree — callers re-invoke
        after any eviction, since pruning can detach nodes an earlier
        walk returned."""
        node, depth = self._walk(tokens)
        if depth < self._node_depth(node):
            node = self._split(node, depth)
        if depth < len(tokens):
            child = _Node(list(tokens[depth:]), node)
            node.children[tokens[depth]] = child
            node = child
        return node

    def _register(self, entry: PrefixEntry, node: "_Node") -> PrefixEntry:
        self._tick += 1
        entry.last_used = self._tick
        entry.node = node
        node.entry = entry
        self._entries.append(entry)
        self.epoch += 1
        return entry

    def _node_depth(self, node: "_Node") -> int:
        d = 0
        while node.parent is not None:
            d += len(node.edge)
            node = node.parent
        return d

    def _split(self, node: "_Node", depth: int) -> "_Node":
        """Split ``node``'s edge so a node boundary lands at ``depth``
        (the walk diverged mid-edge); returns the new upper node."""
        offset = depth - self._node_depth(node.parent)
        upper = _Node(node.edge[:offset], node.parent)
        node.parent.children[upper.edge[0]] = upper
        node.edge = node.edge[offset:]
        node.parent = upper
        upper.children[node.edge[0]] = node
        return upper

    # -- warm-restart checkpoint (host side only) ------------------------
    @staticmethod
    def _tokens_of(node: "_Node") -> "list[int]":
        """The full token run a terminal node indexes (root to node)."""
        parts: "list[list[int]]" = []
        while node is not None and node.parent is not None:
            parts.append(node.edge)
            node = node.parent
        out: "list[int]" = []
        for edge in reversed(parts):
            out.extend(edge)
        return out

    def export_index(self) -> "list[dict]":
        """The index as plain JSON-able data, hottest first (by hits,
        then recency): each entry's token run, hits and last use.  No KV
        rides along: a restarted engine re-prefills the runs
        (`ServeEngine.warm_start`)."""
        entries = sorted(self._entries, key=lambda e: (-e.hits, -e.last_used))
        return [
            {"tokens": self._tokens_of(e.node), "hits": e.hits, "last_used": e.last_used}
            for e in entries
        ]

    # -- introspection ---------------------------------------------------
    @property
    def resident(self) -> int:
        return len(self._entries)

    def stats(self) -> "dict[str, int]":
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "resident": self.resident,
            "pool_slots": self.pool_slots,
            "epoch": self.epoch,
        }


class PrefixCache(_RadixIndex):
    """Row-backed: the radix index over a device pool of prefix rows (one
    `decode.init_cache` of ``pool_slots`` rows on ``device``, bf16 or
    int8, the engine cache's format).

    The cache never computes: it hands back (entry, usable length) pairs
    and pool rows.  The caller copies KV in and out of ``self.pool``
    (`decode.copy_prefix_into_row`) and owns the pins
    (`acquire`/`release`)."""

    def __init__(self, config, pool_slots: int, *, kv_int8: bool = False,
                 device="cuda", mesh=None):
        if pool_slots < 1:
            raise ValueError(f"prefix pool needs at least one slot, got {pool_slots}")
        super().__init__()
        self.config = config
        self.pool_slots = pool_slots
        if mesh is None:
            self.pool = init_cache(config, pool_slots, kv_int8, device=device)
        else:
            # Every row, the rank's heads, on the rank's device.
            place = spmd.Place(mesh)
            self.pool = _kv_cache(config, pool_slots, _local_heads(config, place), kv_int8,
                                  place.device)
        self._free: "list[int]" = list(range(pool_slots))

    def _evict_lru(self) -> "int | None":
        """Evict the least recently used unpinned entry; returns its pool
        row, or None when every entry is pinned."""
        victim = self._pick_victim()
        if victim is None:
            return None
        self._detach(victim)
        self.evictions += 1
        self.epoch += 1
        SERVE_PREFIX_EVICTIONS.inc()
        return victim.slot

    def insert(self, tokens: "list[int]") -> "PrefixEntry | None":
        """Index ``tokens`` as a resident prefix and return its entry,
        pinned once (the admitting row holds it until its request
        finishes; callers `release`).  The exact run already resident is
        acquired and returned, checked before a row is allocated, so a
        duplicate never evicts another entry.  Otherwise a free pool row,
        or the LRU unpinned entry's; None (nothing stored) when every
        row is pinned.  The caller then copies the prompt's KV into
        ``entry.slot``."""
        if not tokens:
            raise ValueError("cannot index an empty prefix")
        existing = self._exact_resident(tokens)
        if existing is not None:
            self.acquire(existing)
            return existing
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._evict_lru()
            if slot is None:
                return None
        # Eviction prunes empty branches, which can detach a node a walk
        # before it returned: _attach walks the tree as it is now.
        node = self._attach(tokens)
        entry = PrefixEntry(slot=slot, length=len(tokens), refcount=1)
        return self._register(entry, node)


class PagedPrefixCache(_RadixIndex):
    """Paged: the radix index over BLOCK-BACKED entries.  Owns no device
    memory — each entry holds a list of block ids into the engine's
    block pool, one `paged.BlockAllocator` reference per block.  A hit
    is an alias (the engine refs the window-aligned prefix blocks into
    the new request's table — zero device copies); parking a prompt is
    free (the entry refs the blocks the admission just wrote).

    ``max_entries`` caps the RESIDENT ENTRY count (the knob the engine's
    ``prefix_cache_slots`` maps to); the real storage bound is the block
    pool, enforced by the engine's admission control via `evict_one`.

    Eviction is BLOCK-GRANULAR when ``block_size`` is given (the engine
    always passes its block width): under pressure `evict_one` trims the
    coldest unpinned entry's TAIL block — the shared hot head (the part
    every family member aliases) stays resident while the cold
    per-prompt tail returns to the pool, so entries SHRINK before they
    die.  Coldness comes from the allocator's per-block heat records
    (`BlockAllocator.last_touch_step`), and tails whose release would
    actually free a block (refcount 1) outrank still-shared ones.  An
    entry trimmed below one usable window is detached outright (a
    sub-window stub can never clear ``min_use``), and a later admission
    of the full run RE-EXTENDS the trimmed entry (`insert` swaps in the
    recomputed block list).  Without ``block_size`` (direct test
    constructions) `evict_one` falls back to whole-entry eviction."""

    def __init__(self, max_entries: int, allocator,
                 *, block_size: "int | None" = None):
        if max_entries < 1:
            raise ValueError(
                f"prefix pool needs at least one slot, got {max_entries}"
            )
        if block_size is not None and block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}"
            )
        super().__init__()
        self.pool_slots = max_entries
        self._alloc = allocator
        self._block_size = block_size
        # Tail blocks trimmed off still-resident entries (the partial
        # evictions `evictions` does not count — that stays whole-entry
        # deaths, the series consumers already chart).
        self.trimmed_blocks = 0

    def evict_entry(self) -> bool:
        """Evict the LRU unpinned entry WHOLE, dropping its block
        references (blocks free only when no live table still points at
        them).  False when every entry is pinned by mid-decode rows —
        the engine's admission control then parks the request instead
        of corrupting a pinned prefix.  The entry-cap path (`insert`)
        uses this form directly: the cap bounds entry COUNT, which only
        a whole-entry death reduces."""
        victim = self._pick_victim()
        if victim is None:
            return False
        blocks = victim.blocks or []
        victim.blocks = None
        self._detach(victim)
        self._alloc.unref(blocks)
        self.evictions += 1
        self.epoch += 1
        SERVE_PREFIX_EVICTIONS.inc()
        return True

    def _trim_victim(self) -> "PrefixEntry | None":
        """The unpinned entry with the COLDEST tail block: freeable
        (refcount 1) tails first, then least-recently-touched block,
        then LRU entry — the block-granular analog of `_pick_victim`."""
        best = None
        best_key = None
        for e in self._entries:
            if e.refcount > 0 or not e.blocks:
                continue
            tail = e.blocks[-1]
            key = (
                self._alloc.refcount(tail) > 1,
                self._alloc.last_touch_step(tail),
                e.last_used,
            )
            if best is None or key < best_key:
                best, best_key = e, key
        return best

    def evict_one(self, current_step: "int | None" = None) -> bool:
        """Release one block's worth of cache claim, coldest-tail-first
        (see the class docstring); ``current_step`` stamps the
        allocator's heat records.  False when every entry is pinned —
        the engine then escalates to preemption or parks."""
        if self._block_size is None:
            return self.evict_entry()
        victim = self._trim_victim()
        if victim is None:
            return False
        tail = victim.blocks.pop()
        self._alloc.unref([tail], step=current_step)
        self.trimmed_blocks += 1
        new_len = len(victim.blocks) * self._block_size
        if new_len >= self._block_size:
            # Shrink: the head stays usable at the new window-aligned
            # length (match/peek cap on entry.length, so the tree needs
            # no surgery).  Residency changed — digests must refresh.
            victim.length = min(victim.length, new_len)
            self.epoch += 1
        else:
            # Trimmed below one window: a stub no lookup can use.
            victim.blocks = None
            self._detach(victim)
            self.evictions += 1
            self.epoch += 1
            SERVE_PREFIX_EVICTIONS.inc()
        return True

    def insert(self, tokens: "list[int]",
               blocks: "list[int]") -> "PrefixEntry | None":
        """Index ``tokens`` as a resident prefix backed by ``blocks``
        (the admission's prompt blocks, ``ceil(len(tokens) / W)`` of
        them — the entry takes one allocator reference per block, the
        caller keeps its own).  Pre-pinned (``refcount == 1``); returns
        the EXISTING entry (blocks untouched) when the exact run is
        already resident AT FULL LENGTH — an entry the block-granular
        LRU trimmed is RE-EXTENDED instead (the admission recomputed
        the whole prompt, so its block list replaces the stub's).
        ``None`` when the entry cap is reached with every resident
        entry pinned."""
        if not tokens:
            raise ValueError("cannot index an empty prefix")
        existing = self._exact_resident(tokens)
        if existing is not None:
            if existing.length < len(tokens):
                # Re-extension: ref the new list BEFORE unreffing the
                # old — the shared head blocks appear in both, and a
                # transient zero refcount would free them under a live
                # table.
                old = existing.blocks or []
                self._alloc.ref(blocks)
                existing.blocks = list(blocks)
                existing.length = len(tokens)
                self._alloc.unref(old)
                self.epoch += 1
            self.acquire(existing)
            return existing
        if len(self._entries) >= self.pool_slots and not self.evict_entry():
            return None
        self._alloc.ref(blocks)
        node = self._attach(tokens)
        entry = PrefixEntry(
            slot=-1, length=len(tokens), refcount=1, blocks=list(blocks)
        )
        return self._register(entry, node)

    def stats(self) -> "dict[str, int]":
        out = super().stats()
        out["trimmed_blocks"] = self.trimmed_blocks
        return out

    def export_blocks(self) -> "list[dict]":
        """The resident entries' block holdings as plain data — one dict
        per entry (token-run length, hotness, pin count, block-id list).
        A block-conservation check reads the entry side of the refcounts
        from here instead of poking the radix tree."""
        return [
            {
                "length": e.length,
                "hits": e.hits,
                "refcount": e.refcount,
                "blocks": list(e.blocks or ()),
            }
            for e in self._entries
        ]
