"""Parameters from elsewhere, and their serving form.

The reference draws its weights from ``jax.random``; a `torch.Generator`
gives other numbers from the same seed.  So a parity test takes the
reference's own tree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and hands it to
`params_from_numpy` — this module never sees JAX itself.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.parallel.device import resolve_device

__all__ = ["MATRICES", "cast_matrices", "params_from_numpy"]

# The per-layer matrices every use casts to bf16.  Holding them as bf16
# once gives the same values (the cast rounds to nearest-even either way)
# without a cast of every weight on every step.  `embed` is not among
# them: the token lookup adds its rows in f32, and only the logits
# product casts it.
MATRICES = ("wqkv", "wo", "w1", "w2")


def cast_matrices(params):
    """``params`` with the layer matrices as bf16 copies (a new tree; the
    other leaves are shared, bf16 matrices are passed through)."""
    layers = dict(params["layers"])
    for name in MATRICES:
        layers[name] = layers[name].to(torch.bfloat16)
    return {**params, "layers": layers}


def params_from_numpy(tree, device: "str | torch.device" = "cuda"):
    """The port's params from the reference's tree as numpy arrays: the
    same keys and stacked ``(L, ...)`` leaves — ``wqkv (L,d,3,H,K)``,
    ``wo (L,H,K,d)``, ``w1 (L,d,f)``, ``w2 (L,f,d)``, ``ln1``/``ln2
    (L,d)``, ``embed (V,d)``, ``pos (seq,d)``, ``ln_f (d)`` — with the
    layer matrices as bf16 (`cast_matrices`) and everything else f32."""
    dev = resolve_device(device)

    def leaf(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    params = {
        "embed": leaf(tree["embed"]),
        "pos": leaf(tree["pos"]),
        "layers": {name: leaf(a) for name, a in tree["layers"].items()},
        "ln_f": leaf(tree["ln_f"]),
    }
    return cast_matrices(params)
