"""JAX's Threefry-2x32 PRNG, bit for bit, in PyTorch tensor ops.

The subset of `jax.random` that the reference's decoding draws from
(`tpu_dra.parallel.decode._make_pick`, the engine's request-keyed
`pick_row`, the speculative decoder) and its synthetic training data
(`tpu_dra.parallel.burnin.sample_tokens`: `randint`, `bernoulli`), as
JAX 0.9 computes it with its
defaults (``threefry2x32``, ``jax_threefry_partitionable=True``): the
same keys give the same bits, so the port samples the same tokens as the
reference wherever the two runs' logits do not straddle a near-tie.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; leading
dims batch independent keys, so every row of a decode step draws from
its own key in one vectorized pass.  All arithmetic is int64 masked to 32
bits (PyTorch's uint32 support is partial); the card and the CPU give the
same integers.  Floats are float32 only: the reference's logits are f32
everywhere, and other widths raise.

Counters follow JAX's ``iota_2x32_shape``: a draw of ``shape`` hashes the
flat index of each element, as a (hi, lo) pair of words, under its key.
With one key for a ``(B, V)`` draw the counter of row ``b``, token ``v``
is ``b * V + v`` (`make_generate`'s layout); with ``(B, 2)`` keys and a
``(V,)`` draw each row counts ``v`` alone (the engine's ``vmap``-ed
layout).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "bernoulli",
    "bits",
    "categorical",
    "fold_in",
    "gumbel",
    "key",
    "randint",
    "split",
    "threefry_2x32",
    "uniform",
]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
# float32's smallest normal: JAX's gumbel draws uniforms in [tiny, 1).
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``: int64 tensors (or ints) of uint32
    values, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _as_key(k, device=None):
    k = torch.as_tensor(k, dtype=torch.int64, device=device)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is a (..., 2) tensor of uint32 words, got {tuple(k.shape)}")
    return k & _MASK


def key(seed, device=None):
    """The raw key of an integer seed (an int, or an int tensor of any
    shape for a batch of keys): ``(0, seed mod 2**32)``, JAX's
    ``PRNGKey`` of a seed in the int32 range (``PRNGKey(-1)`` is ``[0,
    4294967295]``)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k, data):
    """``jax.random.fold_in``: the key hashed with counter ``(0, data)``.
    ``data`` (an int or an int tensor, taken mod 2**32) broadcasts
    against the key's batch dims."""
    k = _as_key(k)
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    o1, o2 = threefry_2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def _counters(shape, device):
    """JAX's ``iota_2x32_shape``: the flat index of every element of
    ``shape`` as (hi, lo) words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _hash_shape(k, shape):
    """Threefry of every counter of ``shape`` under each key of ``k``:
    two words of shape ``(*k.shape[:-1], *shape)``."""
    k = _as_key(k)
    shape = tuple(int(d) for d in shape)
    hi, lo = _counters(shape, k.device)
    lead = k.shape[:-1]
    expand = (...,) + (None,) * len(shape)
    return threefry_2x32(k[..., 0][expand], k[..., 1][expand],
                         hi.expand(*lead, *shape), lo.expand(*lead, *shape))


def split(k, num=2):
    """``jax.random.split``: ``num`` (an int or a shape) new keys, the
    hash of counters ``0..num-1``; shape ``(*batch, *num, 2)``."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    o1, o2 = _hash_shape(k, shape)
    return torch.stack([o1, o2], dim=-1)


def bits(k, shape):
    """``jax.random.bits`` at 32 bits: ``x0 ^ x1`` of the hash of each
    element's counter; int64 values in [0, 2**32), shape ``(*batch,
    *shape)``."""
    o1, o2 = _hash_shape(k, shape)
    return o1 ^ o2


def _check_f32(dtype) -> None:
    if dtype != torch.float32:
        raise ValueError(f"only float32 draws are ported (the reference's logits are f32), got {dtype}")


def uniform(k, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform``: the top 23 bits of `bits` as the mantissa
    of a float in [1, 2), minus 1, scaled into [minval, maxval) in
    float32 and clamped below at ``minval``."""
    _check_f32(dtype)
    b = bits(k, shape)
    one = (b >> 9) | 0x3F800000  # below 2**31: exact as int32
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    # The bounds and their span as float32 values, which the f32 tensor
    # arithmetic takes exactly (no device copy of a host scalar).
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return (floats * span + lo).clamp(min=lo)


def bernoulli(k, p: float, shape):
    """``jax.random.bernoulli`` in its default ``mode="low"``: a float32
    `uniform` below ``p`` (taken as float32, as JAX takes a Python
    float)."""
    return uniform(k, shape) < float(np.float32(p))


def randint(k, shape, minval: int, maxval: int):
    """``jax.random.randint`` for int32 (JAX's default integer): two
    words of `bits` per element, from the two halves of ``split(k)``,
    folded into ``[minval, maxval)`` with JAX's span multiplier
    ``(2**16 % span)**2 % span`` in uint32 arithmetic; ``maxval <= minval``
    gives ``minval``.  Bounds outside int32 raise, as JAX's
    do.  Returns an int32 tensor of shape ``(*batch, *shape)``."""
    for bound in (minval, maxval):
        if not _I32_MIN <= bound <= _I32_MAX:
            raise OverflowError(f"randint bound {bound} is outside int32")
    keys = split(k)
    higher, lower = bits(keys[..., 0, :], shape), bits(keys[..., 1, :], shape)
    span = (maxval - minval) if maxval > minval else 1  # below 2**32: a uint32
    # The square wraps as uint32, so the multiplier is 0 for any span above
    # 2**16, and below it every product is under 2**32: int64 holds them.
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = (((higher % span) * multiplier + lower % span) & _MASK) % span
    value = minval + offset  # inside [minval, maxval): an int32
    return value.to(torch.int32)


def gumbel(k, shape, dtype=torch.float32):
    """``jax.random.gumbel`` in its default ``mode="low"``:
    ``-log(-log(u))`` for ``u`` uniform in [tiny, 1).  On the CPU the two
    logs are taken in float64 and rounded once: torch's vectorized
    float32 ``log`` there can return a thread's chunk of a draw above
    32768 elements off on its first multithreaded call in a process.
    On a card they are float32."""
    _check_f32(dtype)
    u = uniform(k, shape, dtype, minval=_F32_TINY, maxval=1.0)
    if u.device.type == "cpu":
        return (-torch.log(-torch.log(u.double()))).to(dtype)
    return -torch.log(-torch.log(u))


def categorical(k, logits):
    """``jax.random.categorical`` over the last axis: ``argmax(logits +
    g)``, the first maximum winning, as int64.  ``k`` is one key (its
    Gumbel draw spans the whole of ``logits``, counters flat over every
    element) or a batch of keys matching ``logits``' leading dims (each
    row draws over its own last axis)."""
    _check_f32(logits.dtype)
    lead = k.dim() - 1 if torch.is_tensor(k) else torch.as_tensor(k).dim() - 1
    g = gumbel(k, logits.shape[lead:])
    if g.shape != logits.shape:
        raise ValueError(
            f"keys of batch shape {tuple(g.shape[:lead])} do not match logits {tuple(logits.shape)}"
        )
    return torch.argmax(g + logits, dim=-1)
