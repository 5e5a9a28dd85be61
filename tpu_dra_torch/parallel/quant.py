"""Weight-only int8 quantization for the serving path.

Counterpart of `tpu_dra.parallel.quant` on one device.  Scheme:
symmetric per-output-channel int8.  For a weight ``W`` with contraction
axes ``C`` (the dims its matmul sums over)::

    s = amax(|W|, axis=C, keepdims=True) / 127
    q = round(W / s)  in  int8,   W  ~  q * s

A quantized leaf is a ``{"q": int8, "s": f32}`` dict (``s`` keeps the
contraction dims as size 1), so the params tree keeps its structure.
The large matmul operands are quantized (``wqkv``, ``wo``, ``w1``,
``w2``, ``embed``); ``pos`` and the norm gains stay f32.  The same
``{"q","s"}`` convention stores an int8 KV cache or block pool, one
scale per (token, head).

The reference dequantizes inside its jit, where XLA fuses the convert
and scale into each matmul's operand read.  PyTorch runs eagerly, so the
serving path dequantizes a layer at use with `dequantize_bf16`: one pass
that reads int8 and writes bf16, and a plain matmul after it.
"""

from __future__ import annotations

import torch

__all__ = [
    "dequantize",
    "dequantize_bf16",
    "is_quantized",
    "is_quantized_leaf",
    "quantize_params",
    "quantize_tensor",
    "tree_bytes",
]

# Quantized leaf name -> contraction axes of its consuming matmul (the
# leading stacked-layer dim included in the index).
_CONTRACT_AXES = {
    "embed": (1,),        # (V, D): logits contract D; gather scales per row
    "wqkv": (1,),         # (L, D, 3, H, K): contract D
    "wo": (1, 2),         # (L, H, K, D): contract H, K
    "w1": (1,),           # (L, D, F): contract D
    "w2": (1,),           # (L, F, D): contract F
}


def quantize_tensor(w, contract_axes: "tuple[int, ...]") -> dict:
    """Symmetric per-channel int8: ``{"q": int8, "s": f32 keepdims}``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    w = w.float()
    amax = w.abs().amax(dim=contract_axes, keepdim=True)
    s = torch.where(amax > 0, amax, 1.0) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def is_quantized_leaf(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf.keys()) == {"q", "s"}


def is_quantized(params: dict) -> bool:
    """True iff the params tree came from `quantize_params`."""
    return is_quantized_leaf(params.get("embed"))


def dequantize(leaf):
    """``{"q","s"}`` -> f32 tensor ``q * s``; passes plain tensors
    through, so layer dicts can be mapped blindly."""
    if not is_quantized_leaf(leaf):
        return leaf
    return leaf["q"].float() * leaf["s"]


def dequantize_bf16(leaf):
    """``{"q","s"}`` -> bf16 tensor ``bf16(f32(q) * s)``, the value the
    reference's ``dequantize(leaf).astype(bf16)`` gives, in one pass: the
    product runs in f32 and rounds once on its bf16 store, so no f32
    temporary is written.  Passes plain tensors through."""
    if not is_quantized_leaf(leaf):
        return leaf
    q = leaf["q"]
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    return torch.mul(q, leaf["s"], out=out)


def quantize_params(params: dict) -> dict:
    """Quantize a `burnin.init_params` tree for serving: the same tree
    with each large-matmul leaf replaced by its ``{"q","s"}`` pair and
    everything else (pos, norms) kept as it is."""
    layers = dict(params["layers"])
    for name, axes in _CONTRACT_AXES.items():
        if name != "embed" and name in layers:
            layers[name] = quantize_tensor(layers[name], axes)
    return {
        **params,
        "embed": quantize_tensor(params["embed"], _CONTRACT_AXES["embed"]),
        "layers": layers,
    }


def tree_bytes(tree) -> int:
    """Total bytes of the tensors of a nested dict (a params tree, a
    cache or a pool, quantized or not)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
