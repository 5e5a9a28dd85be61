"""Seeded weights of the burn-in LM, made on the device.

The benchmark makes the weights and hands the same tensors to the
program and to the plain reference.  Each leaf is one ``torch.randn``
call on the device under a generator of its own, seeded from the run's
seed and the leaf's index, so any one leaf can be made again alone (the
training check rebuilds the starting weights leaf by leaf).  Values are
``randn / sqrt(fan_in)`` in the leaf's dtype; the norms' scales are ones.

The tree is the program's layout: ``embed (V, d)``, ``pos (seq, d)``,
``ln_f (d,)`` and under ``layers`` the stacked ``(L, ...)`` leaves
``wqkv (L, d, 3, H, K)``, ``wo (L, H, K, d)``, ``ln1``/``ln2 (L, d)``
and ``w1 (L, d, f)``, ``w2 (L, f, d)``, or with experts ``router (L, d,
E)``, ``w1e (L, E, d, f)``, ``w2e (L, E, f, d)``.
"""

from __future__ import annotations

import torch

MATRICES = ("wqkv", "wo", "w1", "w2", "w1e", "w2e")


def leaves(m: dict) -> "list[tuple[str, tuple[int, ...], int]]":
    """``(path, shape, fan_in)`` of every drawn leaf, in a fixed order;
    ``fan_in`` 0 marks a norm scale (ones)."""
    V, d, H, f, L, E = m["vocab"], m["d_model"], m["n_heads"], m["d_ff"], m["n_layers"], \
        m.get("moe_experts", 0)
    K = d // H
    out = [
        ("embed", (V, d), d),
        ("pos", (m["seq"], d), d),
        ("layers.wqkv", (L, d, 3, H, K), d),
        ("layers.wo", (L, H, K, d), d),
    ]
    if E:
        out += [("layers.router", (L, d, E), d), ("layers.w1e", (L, E, d, f), d),
                ("layers.w2e", (L, E, f, d), f)]
    else:
        out += [("layers.w1", (L, d, f), d), ("layers.w2", (L, f, d), f)]
    out += [("layers.ln1", (L, d), 0), ("layers.ln2", (L, d), 0), ("ln_f", (d,), 0)]
    return out


def _leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


def make_leaf(m: dict, path: str, seed: int, device, dtype) -> torch.Tensor:
    """One leaf, as `make_params` makes it."""
    for i, (p, shape, fan_in) in enumerate(leaves(m)):
        if p == path:
            if fan_in == 0:
                return torch.ones(shape, dtype=torch.float32, device=device)
            g = torch.Generator(device=device).manual_seed(_leaf_seed(seed, i))
            t = torch.randn(shape, generator=g, device=device, dtype=dtype)
            return t.mul_(fan_in ** -0.5)
    raise KeyError(path)


def leaf_dtype(path: str, matrices) -> torch.dtype:
    """The layer matrices in ``matrices``' dtype, every other leaf f32
    (the embedding, the position table and the router are f32 as served)."""
    return matrices if path.split(".")[-1] in MATRICES else torch.float32


def make_params(m: dict, seed: int, device, *, matrices=torch.bfloat16) -> dict:
    """The whole tree from ``seed``, the layer matrices in ``matrices``'
    dtype (bf16 as served, f32 as trained)."""
    tree: dict = {"layers": {}}
    for path, _, _ in leaves(m):
        t = make_leaf(m, path, seed, device, leaf_dtype(path, matrices))
        if path.startswith("layers."):
            tree["layers"][path.split(".", 1)[1]] = t
        else:
            tree[path] = t
    return tree


def get(tree: dict, path: str) -> torch.Tensor:
    """The leaf of ``tree`` at ``path`` (``"embed"``, ``"layers.w1"``)."""
    node = tree
    for part in path.split("."):
        node = node[part]
    return node
