"""The single-device attention oracle.

Counterpart of `tpu_dra.parallel.ring.reference_attention` only: the
ring itself (context parallelism over ``torch.distributed``) waits for
the multi-device slice.  The flash kernel is held against this function,
and its backward differentiates it.

Rounding follows the reference's source point for point, which differs
from the dense attention of `burnin._block`:

- the score einsum leaves in q's dtype (bf16 in the model);
- it is widened to f32 and *then* divided by sqrt(d) in f32;
- masked scores are set to -1e30;
- the probabilities are cast to v's dtype before the V product.
"""

from __future__ import annotations

import torch

__all__ = ["reference_attention"]

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
