"""Parameters from elsewhere, and their serving form.

The reference draws its weights from ``jax.random``; a `torch.Generator`
gives other numbers from the same seed.  So a parity test takes the
reference's own tree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and hands it to
`params_from_numpy` (the serving form) or its training state to
`state_from_numpy` — this module never sees JAX itself.  For the sharded
step, `shard_state` cuts that state into one rank's shards and
`gather_state` puts the ranks' shards back together; for serving on a
mesh, `shard_params` cuts a serving tree (bf16 matrices, or int8
``{"q","s"}`` pairs) into one rank's shards.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.burnin import param_specs, state_shardings
from tpu_dra_torch.parallel.collectives import rank_device
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.quant import is_quantized, is_quantized_leaf, quant_param_specs

__all__ = [
    "EXPERT_MATRICES", "MATRICES", "cast_matrices", "gather_state", "params_from_numpy",
    "shard_params", "shard_state", "state_from_numpy",
]

# The per-layer matrices every use casts to bf16, the dense MLP's and the
# experts'.  Holding them as bf16 once gives the same values (the cast
# rounds to nearest-even either way) without a cast of every weight on
# every step.  `embed` is not among them: the token lookup adds its rows
# in f32, and only the logits product casts it.  Nor is the ``router``:
# routing is f32, and a bf16 router would route other tokens.
MATRICES = ("wqkv", "wo", "w1", "w2")
EXPERT_MATRICES = ("w1e", "w2e")


def cast_matrices(params):
    """``params`` with the layer matrices as bf16 copies (a new tree; the
    other leaves are shared; bf16 matrices and int8 ``{"q","s"}`` pairs
    are passed through, and names the tree lacks skipped: a dense tree
    has no expert matrices, an expert tree no ``w1``/``w2``)."""
    layers = dict(params["layers"])
    for name in MATRICES + EXPERT_MATRICES:
        if name in layers and not is_quantized_leaf(layers[name]):
            layers[name] = layers[name].to(torch.bfloat16)
    return {**params, "layers": layers}


def params_from_numpy(tree, device: "str | torch.device" = "cuda"):
    """The port's params from the reference's tree as numpy arrays: the
    same keys and stacked ``(L, ...)`` leaves — ``wqkv (L,d,3,H,K)``,
    ``wo (L,H,K,d)``, ``w1 (L,d,f)``, ``w2 (L,f,d)`` or the experts'
    ``router (L,d,E)``, ``w1e (L,E,d,f)``, ``w2e (L,E,f,d)``,
    ``ln1``/``ln2 (L,d)``, ``embed (V,d)``, ``pos (seq,d)``, ``ln_f (d)``
    — with the layer matrices as bf16 (`cast_matrices`) and everything
    else, the router included, f32.
    A quantized tree (the reference's ``quantize_params``) keeps each
    ``{"q","s"}`` leaf as its int8 values and f32 scales."""
    return cast_matrices(_f32_tree(tree, resolve_device(device)))


def _f32_tree(tree, dev):
    return {
        "embed": _f32(tree["embed"], dev),
        "pos": _f32(tree["pos"], dev),
        "layers": {name: _f32(a, dev) for name, a in tree["layers"].items()},
        "ln_f": _f32(tree["ln_f"], dev),
    }


def _f32(a, dev):
    """One leaf as f32, or a ``{"q","s"}`` pair as int8 and f32."""
    if is_quantized_leaf(a):
        return {"q": torch.tensor(a["q"], dtype=torch.int8, device=dev), "s": _f32(a["s"], dev)}
    return torch.tensor(a, dtype=torch.float32, device=dev)


def state_from_numpy(state, config, device: "str | torch.device" = "cuda"):
    """The port's training state from the reference's ``(params, opt)``
    as numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``).
    Every leaf stays f32 — training updates f32 masters and casts to
    bf16 at each use, so `cast_matrices` is not applied.  ``opt`` is the
    momentum tree, or ``{"m", "v", "t"}`` when ``config.optimizer`` is
    ``"adamw"`` (``t`` a 0-dim int32 tensor)."""
    dev = resolve_device(device)
    params, opt = state
    if config.optimizer == "adamw":
        opt = {
            "m": _f32_tree(opt["m"], dev),
            "v": _f32_tree(opt["v"], dev),
            "t": torch.tensor(opt["t"], dtype=torch.int32, device=dev),
        }
    else:
        opt = _f32_tree(opt, dev)
    return _f32_tree(params, dev), opt


def _coords(mesh, rank: int) -> "dict[str, int]":
    """The place of ``rank`` on each axis: in a `DeviceMesh`, where its
    rank tensor holds ``rank``; in ``{axis: size}``, ``rank`` read as a
    row-major index over the axes."""
    sizes = spmd.mesh_sizes(mesh)
    if hasattr(mesh, "mesh"):
        where = (mesh.mesh == rank).nonzero()
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {mesh.mesh.tolist()}")
        return dict(zip(sizes, (int(i) for i in where[0])))
    coords = {}
    for axis in reversed(list(sizes)):
        rank, coords[axis] = divmod(rank, sizes[axis])
    return dict(reversed(list(coords.items())))


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {key: _zip_map(fn, tree[key], specs[key]) for key in tree}
    return fn(tree, specs)


def shard_state(state, config, mesh, rank: int, device: "str | torch.device" = "cuda"):
    """One rank's shards of the reference's ``(params, opt)`` as numpy
    arrays (`state_from_numpy`'s input): each leaf cut by
    `burnin.state_shardings` at the rank's place on ``mesh`` (a
    `DeviceMesh`, ``rank`` a rank it holds; or ``{axis: size}``, ``rank``
    the row-major index), as f32 tensors on ``device`` (AdamW's ``t``
    int32) — the state `burnin.make_train_step`'s step takes on that
    rank.  ``config`` must fit the mesh (`BurninConfig.scaled_to`)."""
    dev = resolve_device(device)
    sizes, coords = spmd.mesh_sizes(mesh), _coords(mesh, rank)

    def cut(a, spec):
        a = np.asarray(a)
        if spec == ():
            return torch.tensor(a, dtype=torch.int32, device=dev)
        block = a[spmd.local_slices(spec, a.shape, sizes, coords)]
        return torch.tensor(np.ascontiguousarray(block), dtype=torch.float32, device=dev)

    specs = state_shardings(config, sizes)
    return tuple(_zip_map(cut, part, spec) for part, spec in zip(state, specs))


def shard_params(params, config, mesh, rank: "int | None" = None,
                 device: "str | torch.device | None" = None):
    """One rank's shards of a serving tree: ``params`` as `cast_matrices`
    or `quant.quantize_params` leave it (tensors, or numpy arrays), each
    leaf cut by `burnin.param_specs` (a quantized tree by
    `quant.quant_param_specs`) at the rank's place on ``mesh`` (a
    `DeviceMesh`, ``rank`` default this process's rank; or ``{axis:
    size}``, ``rank`` the row-major index), every leaf keeping its dtype.
    ``device`` defaults to the rank's device on a `DeviceMesh`, else
    ``"cuda"``.  A leaf the rank holds whole on its device comes back as
    a view of it (no copy).  Quantize the whole tree, then cut it: a per-channel scale
    taken over a shard of its contraction dim is not the whole tree's."""
    sizes = spmd.mesh_sizes(mesh)
    if rank is None:
        rank = torch.distributed.get_rank()
    coords = _coords(mesh, rank)
    if device is None:
        dev = rank_device(mesh) if hasattr(mesh, "mesh") else resolve_device("cuda")
    else:
        dev = resolve_device(device)
    specs = (quant_param_specs if is_quantized(params) else param_specs)(config, sizes)

    def cut(leaf, spec):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        return t[spmd.local_slices(spec, t.shape, sizes, coords)].contiguous().to(dev)

    return _zip_map(cut, params, specs)


def gather_state(shards, config, mesh):
    """The whole state as numpy arrays from every rank's shards
    (``shards[r]`` the state of the rank at row-major index ``r`` of
    ``mesh``, ``{axis: size}`` or a `DeviceMesh` whose rank tensor is
    read row-major): the inverse of `shard_state`.  A leaf replicated
    over an axis is taken from any one of its ranks."""
    sizes = spmd.mesh_sizes(mesh)
    ranks = mesh.mesh.reshape(-1).tolist() if hasattr(mesh, "mesh") else range(len(shards))

    def whole(specs, *leaves):
        if specs == ():
            return np.asarray(_numpy(leaves[0]))
        shape = [n * _split_ways(sizes, entry) for n, entry in zip(_numpy(leaves[0]).shape, specs)]
        out = np.zeros(shape, dtype=np.float32)
        for rank, leaf in zip(ranks, leaves):
            out[spmd.local_slices(specs, shape, sizes, _coords(mesh, rank))] = _numpy(leaf)
        return out

    def walk(specs, *trees):
        if isinstance(trees[0], dict):
            return {key: walk(specs[key], *(t[key] for t in trees)) for key in trees[0]}
        return whole(specs, *trees)

    specs = state_shardings(config, sizes)
    return tuple(walk(spec, *(shard[i] for shard in shards)) for i, spec in enumerate(specs))


def _split_ways(sizes: "dict[str, int]", entry) -> int:
    """How many ways a spec entry splits its dim."""
    n = 1
    for axis in () if entry is None else (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes.get(axis, 1)
    return n


def _numpy(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
