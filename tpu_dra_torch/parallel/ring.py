"""Ring attention over a mesh axis, and the single-device attention oracle.

Counterpart of `tpu_dra.parallel.ring`.  Context parallelism for long
sequences: every rank holds one contiguous block of the sequence's Q, K
and V, and the K/V blocks rotate around the ``model`` axis's ring (one
hop a step, `spmd.shift`) while each rank folds them into its queries'
online softmax (running max ``m``, numerator ``num``, denominator
``den``).  Causality is on global positions, so a block wholly in a
query's future contributes exactly zero and the result is the
single-device causal attention.  The reference issues exactly p - 1
rotations, folding the last block outside its loop; so does the port.

Its rounding is the reference's: q and K widened to f32, the scores
multiplied by 1/sqrt(d) after the product, the -1e30 mask, f32 ``num``
and ``den``, and ``num / max(den, 1e-30)`` cast to q's dtype.

The reference differentiates its ``ppermute`` ring with JAX; nothing
differentiates ``torch.distributed``'s point-to-point calls, so the
gradient is an autograd Function.  Its backward runs the ring again: the
K/V blocks rotate as in the forward with the dK/dV accumulators of each
block travelling beside it, each rank adding its queries' part (from the
saved row log-sum-exp, the softmax gradient in f32); after the last
fold a block's accumulators sit one hop short of their owner and take
that hop.

`reference_attention` is the single-device oracle the flash kernel is
held against and whose autograd is its backward.  Its rounding differs
from the dense attention of `burnin._block`:

- the score einsum leaves in q's dtype (bf16 in the model);
- it is widened to f32 and *then* divided by sqrt(d) in f32;
- masked scores are set to -1e30;
- the probabilities are cast to v's dtype before the V product.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.parallel import spmd

__all__ = ["reference_attention", "ring_attention", "ring_attention_sharded"]

_NEG_INF = -1e30


def reference_attention(q, k, v, *, causal: bool = True):
    """Softmax attention of q (b, s, h, d) against k/v (b, t, h, d);
    returns (b, s, h, d) in v's dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / (d ** 0.5)
    if causal:
        s, t = q.shape[1], k.shape[1]
        mask = torch.arange(s, device=q.device)[:, None] >= torch.arange(t, device=q.device)[None, :]
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def _scores(q32, k_blk, q_pos, src: int, scale: float, causal: bool):
    """f32 scores (b, h, s, t) of the rank's queries against the block
    that rank ``src`` owns, masked on global positions."""
    t = k_blk.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q32, k_blk.float()) * scale
    if causal:
        kv_pos = src * t + torch.arange(t, device=q32.device)
        scores = torch.where((q_pos[:, None] >= kv_pos[None, :])[None, None], scores, _NEG_INF)
    return scores


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, place, axis, causal):
        p, my = place.size(axis), place.index(axis)
        b, s, h, d = q.shape
        scale = 1.0 / (d ** 0.5)
        q32 = q.float()
        q_pos = my * s + torch.arange(s, device=q.device)
        m = torch.full((b, h, s), _NEG_INF, device=q.device)
        num = torch.zeros((b, h, s, d), device=q.device)
        den = torch.zeros((b, h, s), device=q.device)
        k_blk, v_blk, src = k, v, my

        def fold(k_blk, v_blk, src, m, num, den):
            scores = _scores(q32, k_blk, q_pos, src, scale, causal)
            new_m = torch.maximum(m, scores.amax(-1))
            alpha = torch.exp(m - new_m)
            probs = torch.exp(scores - new_m[..., None])
            num = num * alpha[..., None] + torch.einsum("bhst,bthd->bhsd", probs, v_blk.float())
            den = den * alpha + probs.sum(-1)
            return new_m, num, den

        # Step r folds the block of rank (my - r) mod p; the last block is
        # folded after the loop, so exactly p - 1 rotations are issued.
        for _ in range(p - 1):
            m, num, den = fold(k_blk, v_blk, src, m, num, den)
            k_blk, v_blk = spmd.shift([k_blk, v_blk], place, axis)
            src = (src - 1) % p
        m, num, den = fold(k_blk, v_blk, src, m, num, den)
        # Causal + the rank's own block folded first => den > 0; the floor
        # guards a non-causal all-masked edge.
        out = num / torch.clamp(den[..., None], min=1e-30)  # (b, h, s, d) f32
        lse = m + torch.log(den)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.place, ctx.axis, ctx.causal = place, axis, causal
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        place, axis, causal = ctx.place, ctx.axis, ctx.causal
        p, my = place.size(axis), place.index(axis)
        b, s, h, d = q.shape
        scale = 1.0 / (d ** 0.5)
        q32 = q.float()
        q_pos = my * s + torch.arange(s, device=q.device)
        g32 = g.float().transpose(1, 2)  # (b, h, s, d)
        delta = (g32 * out).sum(-1)  # (b, h, s): rowsum(dP * P) of the softmax gradient
        dq = torch.zeros((b, h, s, d), device=q.device)
        k_blk, v_blk, src = k, v, my
        dk = torch.zeros(k.shape, device=q.device)
        dv = torch.zeros(v.shape, device=q.device)
        for r in range(p):
            probs = torch.exp(_scores(q32, k_blk, q_pos, src, scale, causal) - lse[..., None])
            dv = dv + torch.einsum("bhst,bhsd->bthd", probs, g32)
            dp = torch.einsum("bhsd,bthd->bhst", g32, v_blk.float())
            ds = probs * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhst,bthd->bhsd", ds, k_blk.float())
            dk = dk + torch.einsum("bhst,bshd->bthd", ds, q32)
            if r < p - 1:
                k_blk, v_blk, dk, dv = spmd.shift([k_blk, v_blk, dk, dv], place, axis)
                src = (src - 1) % p
        # Block j's accumulators end on rank j - 1: one hop home.
        dk, dv = spmd.shift([dk, dv], place, axis)
        return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def ring_attention(q, k, v, place: "spmd.Place", axis: str, *, causal: bool = True):
    """Blockwise ring attention over ``axis`` of ``place``'s mesh, on the
    rank's blocks: q, k, v (b, s_local, h, d), the global sequence the
    blocks in axis order.  Returns the rank's output block (b, s_local,
    h, d) in q's dtype; differentiable."""
    return _RingAttention.apply(q, k, v, place, axis, causal)


def ring_attention_sharded(q, k, v, mesh, axis_name: str, *, causal: bool = True):
    """`ring_attention` over ``axis_name`` of a `DeviceMesh` (the
    reference's ``shard_map`` wrapper): q, k, v are the rank's blocks,
    the sequence over ``axis_name``, the batch over the other axes."""
    return ring_attention(q, k, v, spmd.Place(mesh), axis_name, causal=causal)
