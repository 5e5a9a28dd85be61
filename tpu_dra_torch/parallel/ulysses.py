"""Ulysses context parallelism: attention by two all-to-alls over a mesh axis.

Counterpart of `tpu_dra.parallel.ulysses`.  Where the ring (`ring.py`)
keeps a rank's queries and rotates K/V blocks around the axis, Ulysses
swaps which dim is sharded for the length of attention: an all-to-all
re-shards q, k and v from sequence-sharded (B, S/P, H, d) to
head-sharded (B, S, H/P, d), each rank runs ordinary full-sequence
attention over its own heads, and the inverse all-to-all swaps back.
Each head's attention is the single-device computation: the swaps only
move data.

The reference swaps q, k and v in three collectives; the port stacks
them and swaps one (B, S/P, 3, H, d) tensor (`spmd.all_to_all`, heads
split, sequence concatenated), so that q, k and v come out as views of
one contiguous (B, S, 3, H/P, d) tensor: their head and feature dims
are contiguous, which the flash kernel (K2) requires of its operands,
as on the single-device path where they are views of the qkv product.
The backward of each swap is the inverse swap.  On an axis of one rank
both swaps are the identity and attention runs on q, k and v as given.

``flash=True`` runs `flash.flash_attention` (the kernel's forward on
CUDA tensors, its plain version on CPU ones; the reference attention's
backward), else `ring.reference_attention`.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.ring import reference_attention

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _attend(q, k, v, causal: bool, flash: bool, flash_block: int):
    if flash:
        # Imported here: flash imports the kernels, which import burnin.
        from tpu_dra_torch.parallel.flash import flash_attention

        return flash_attention(q, k, v, causal, flash_block, flash_block)
    return reference_attention(q, k, v, causal=causal)


def ulysses_attention(q, k, v, place: "spmd.Place", axis: str, *, causal: bool = True,
                      flash: bool = False, flash_block: int = 128):
    """Ulysses attention over ``axis`` of ``place``'s mesh, on the rank's
    blocks: q, k, v (B, S/P, H, d) with H % P == 0, the global sequence
    the blocks in axis order.  Returns the rank's output block (B, S/P,
    H, d) in q's dtype; differentiable.  ``flash`` runs the flash kernel
    on the head-swapped view, tiled by ``flash_block``."""
    if place.size(axis) == 1:
        return _attend(q, k, v, causal, flash, flash_block)
    # Sequence-sharded (B, S/P, 3, H, d) -> head-sharded (B, S, 3, H/P, d),
    # contiguous: the rank's heads over the whole sequence.
    qkv = spmd.all_to_all(torch.stack((q, k, v), dim=2), place, axis, split_dim=3,
                          concat_dim=1)
    att = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal, flash, flash_block)
    # Head-sharded -> sequence-sharded: the inverse swap.
    return spmd.all_to_all(att, place, axis, split_dim=1, concat_dim=2)


def ulysses_attention_sharded(q, k, v, mesh, axis_name: str, *, causal: bool = True,
                              flash: bool = False, flash_block: int = 128,
                              seq: "int | None" = None):
    """`ulysses_attention` over ``axis_name`` of a `DeviceMesh` (the
    reference's ``shard_map`` wrapper): q, k, v are the rank's blocks,
    the sequence over ``axis_name``, the batch over the other axes.
    ``seq`` is the global sequence length (default: the rank's block
    times the axis size); the heads and ``seq`` must divide over the
    axis, as the reference requires, and a rank's block is ``seq / P``."""
    place = spmd.Place(mesh)
    n = place.size(axis_name)
    heads = q.shape[2]
    if heads % n:
        raise ValueError(
            f"ulysses needs heads % {axis_name} axis == 0, got "
            f"{heads} heads over {n} shards"
        )
    seq = q.shape[1] * n if seq is None else seq
    if seq % n:
        raise ValueError(
            f"ulysses needs seq % {axis_name} axis == 0, got "
            f"{seq} over {n}"
        )
    if q.shape[1] != seq // n:
        raise ValueError(f"a rank's block is seq / {n} = {seq // n} positions, got {q.shape[1]}")
    return ulysses_attention(q, k, v, place, axis_name, causal=causal, flash=flash,
                             flash_block=flash_block)
