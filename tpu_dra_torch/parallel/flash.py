"""Flash attention with a gradient: the kernel's forward, the oracle's backward.

Counterpart of `tpu_dra.parallel.flash.flash_attention` on one device.
The forward is `kernels.flash_attn.flash_attention_forward` (the CUDA
kernel on CUDA tensors, its plain version on CPU tensors).  The
backward, as the reference's custom VJP does, recomputes attention with
`ring.reference_attention` and differentiates that: the reference has no
backward kernel, so neither does the port.  The two functions round
differently (the forward keeps p in f32; the oracle rounds p to v's
dtype and divides the f32 scores by sqrt(d)); the reference accepts
that, and so does the port.

``interpret`` has no counterpart: the tensors' device picks the path.
`flash_attention_sharded` is the reference's ``shard_map`` of the kernel
over the head axis: one process a rank holds its own heads already, so
it is the kernel (and the same backward) on them, with no collective.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.parallel.kernels.flash_attn import flash_attention_forward
from tpu_dra_torch.parallel.ring import reference_attention
from tpu_dra_torch.parallel.spmd import mesh_sizes

__all__ = ["flash_attention", "flash_attention_sharded"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_forward(q, k, v, causal, block_q, block_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*inputs, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """Softmax attention, flash-tiled, of q (b, s, h, d) against k, v of
    the same shape; differentiable.  ``block_q``/``block_k`` must divide
    s (a ValueError says so)."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


def flash_attention_sharded(q, k, v, mesh, axis_name: str = "model", *, causal: bool = True,
                            block_q: int = 128, block_k: int = 128):
    """Flash attention with the heads sharded over ``axis_name`` of
    ``mesh`` (the tensor-parallel layout), on this rank's tensors: q, k, v
    (b_local, s, h / n, d), the batch over the other axes.  Attention is
    independent a head, so each rank runs `flash_attention` (the kernel
    forward, the reference attention's backward) on its own heads and no
    collective runs, as none runs in the reference's ``shard_map``.  The
    kernel takes q, k and v as they come from the column-parallel
    product (contiguous head and feature dims), never a slice of a
    global qkv tensor."""
    if axis_name not in mesh_sizes(mesh):
        raise ValueError(f"mesh has no axis {axis_name!r}: {tuple(mesh_sizes(mesh))}")
    return flash_attention(q, k, v, causal, block_q, block_k)
