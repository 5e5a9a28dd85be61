"""Parameters from elsewhere, and their serving form.

The reference draws its weights from ``jax.random``; a `torch.Generator`
gives other numbers from the same seed.  So a parity test takes the
reference's own tree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and hands it to
`params_from_numpy` (the serving form) or its training state to
`state_from_numpy` — this module never sees JAX itself.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.quant import is_quantized_leaf

__all__ = ["MATRICES", "cast_matrices", "params_from_numpy", "state_from_numpy"]

# The per-layer matrices every use casts to bf16.  Holding them as bf16
# once gives the same values (the cast rounds to nearest-even either way)
# without a cast of every weight on every step.  `embed` is not among
# them: the token lookup adds its rows in f32, and only the logits
# product casts it.
MATRICES = ("wqkv", "wo", "w1", "w2")


def cast_matrices(params):
    """``params`` with the layer matrices as bf16 copies (a new tree; the
    other leaves are shared; bf16 matrices and int8 ``{"q","s"}`` pairs
    are passed through)."""
    layers = dict(params["layers"])
    for name in MATRICES:
        if not is_quantized_leaf(layers[name]):
            layers[name] = layers[name].to(torch.bfloat16)
    return {**params, "layers": layers}


def params_from_numpy(tree, device: "str | torch.device" = "cuda"):
    """The port's params from the reference's tree as numpy arrays: the
    same keys and stacked ``(L, ...)`` leaves — ``wqkv (L,d,3,H,K)``,
    ``wo (L,H,K,d)``, ``w1 (L,d,f)``, ``w2 (L,f,d)``, ``ln1``/``ln2
    (L,d)``, ``embed (V,d)``, ``pos (seq,d)``, ``ln_f (d)`` — with the
    layer matrices as bf16 (`cast_matrices`) and everything else f32.
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
