"""The burn-in LM in plain PyTorch and float32: the yardstick's reference.

It follows the model's description, not the program's code: token and
position embeddings, then pre-norm blocks of RMSNorm (eps 1e-6), causal
multi-head attention (scores over sqrt(head width)) and a LeakyReLU
(slope 0.01) MLP, or a top-1 switch MLP; a final RMSNorm and the logits
against the tied embedding.  No kernel, cache or batching of requests.

The switch MLP sends each token to the expert of its largest router
probability and scales that expert's output by the probability.  Within
a routed group, a token takes the next place in its expert's queue in
sequence order and is dropped past ``capacity`` places (its MLP output
is zero).  Serving routes a prompt as one group and each generated token
alone, so `forward` takes ``group_len``: the first ``group_len``
positions form the group, every later position is routed alone and kept.

Weights may come in any float dtype; each is read as float32 at use.
Float32 products run without TF32 (`strict_fp32`).  ``fp8=True`` rounds
every product's operands to float8 e4m3 with one scale a tensor (its
largest magnitude at 448) and lets gradients pass straight through: the
control of a training cell, a step below the program's bf16 products.
"""

from __future__ import annotations

import contextlib
import math

import torch

_F8_MAX = 448.0


@contextlib.contextmanager
def strict_fp32():
    """Float32 products in float32, not TF32, inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _F8_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (y - x).detach()


def _mm(a, b, fp8: bool):
    return _fp8(a) @ _fp8(b) if fp8 else a @ b


def rms_norm(x, scale):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * scale.float()


def _leaky(x):
    return torch.where(x > 0, x, 0.01 * x)


def attention(h, wqkv, wo, n_heads: int, fp8: bool = False):
    """Causal multi-head self-attention of ``h`` (B, S, d)."""
    B, S, d = h.shape
    K = d // n_heads
    qkv = _mm(h, wqkv.float().reshape(d, 3 * d), fp8).reshape(B, S, 3, n_heads, K)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, S, K)
    scores = _mm(q, k.transpose(-1, -2), fp8) / math.sqrt(K)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = _mm(probs, v, fp8).transpose(1, 2).reshape(B, S, d)
    return _mm(out, wo.float().reshape(d, d), fp8)


def switch_mlp(h, router, w1e, w2e, capacity: int, group_len: int, margins=None):
    """The top-1 switch MLP of one sequence ``h`` (S, d): positions below
    ``group_len`` queue per expert with ``capacity`` places, later ones
    are routed alone (always kept).  Appends each position's top-2
    probability margin to ``margins`` when given."""
    probs = torch.softmax(h @ router.float(), dim=-1)
    if margins is not None:
        top = probs.topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
    gate, choice = probs.max(dim=-1)
    onehot = torch.nn.functional.one_hot(choice, probs.shape[-1])
    place = torch.cumsum(onehot[:group_len], dim=0) - 1
    kept_group = (place * onehot[:group_len]).sum(-1) < capacity
    keep = torch.ones_like(choice, dtype=torch.bool)
    keep[:group_len] = kept_group
    out = torch.zeros_like(h)
    for e in range(probs.shape[-1]):
        idx = torch.nonzero((choice == e) & keep).flatten()
        if idx.numel():
            a = _leaky(h[idx] @ w1e[e].float())
            out[idx] = gate[idx, None] * (a @ w2e[e].float())
    return out


def forward(params: dict, tokens: torch.Tensor, n_heads: int, *, moe_capacity: int = 0,
            group_len=0, fp8: bool = False, router_margins: "list | None" = None):
    """Logits (B, S, vocab) float32 of ``tokens`` (B, S) from position 0.
    With experts, each row is one sequence routed as `switch_mlp` says,
    ``group_len`` an int or one a row; ``router_margins`` collects each
    layer's (B, S) top-2 margins.  Rows may be padded at the end: a
    position never reads a later one."""
    groups = [group_len] * tokens.shape[0] if isinstance(group_len, int) else list(group_len)
    S = tokens.shape[1]
    x = params["embed"].float()[tokens] + params["pos"].float()[:S][None]
    lay = params["layers"]
    for i in range(lay["wqkv"].shape[0]):
        h = rms_norm(x, lay["ln1"][i])
        x = x + attention(h, lay["wqkv"][i], lay["wo"][i], n_heads, fp8)
        h = rms_norm(x, lay["ln2"][i])
        if "router" in lay:
            marg: "list" = []
            mlp = torch.stack([
                switch_mlp(h[b], lay["router"][i], lay["w1e"][i], lay["w2e"][i],
                           moe_capacity, groups[b], marg)
                for b in range(h.shape[0])])
            if router_margins is not None:
                router_margins.append(torch.stack(marg))
        else:
            mlp = _mm(_leaky(_mm(h, lay["w1"][i].float(), fp8)), lay["w2"][i].float(), fp8)
        x = x + mlp
    x = rms_norm(x, params["ln_f"])
    return _mm(x, params["embed"].float().T, fp8)


def next_token_loss_sum(logits, tokens):
    """Summed cross-entropy of each position's next token."""
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long(),
        reduction="sum")
