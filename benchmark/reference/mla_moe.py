"""Plain float32 reference of DeepSeek-V3's block (Moonlight-16B-A3B):
multi-head latent attention in its expanded form and the dropless top-k
expert layer with shared experts, over one sequence from position 0,
with no cache, no batching and no kernel.

It follows the published equations (DeepSeek-V2 and V3's reports and
inference code) and the published config's keys, which ``cfg`` holds as
a dict: ``hidden_size``, ``num_attention_heads``, ``kv_lora_rank``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``num_experts_per_tok``, ``routed_scaling_factor``, ``rms_norm_eps``,
``rope_theta``.  The weights are the port's tree (one dict a layer: see
`tpu_dra_torch.models.mla_moe.init_params`), read in whatever dtype they
are held in and widened to float32 a matrix at a time, as used.  The
rope rotates interleaved pairs ``(2i, 2i+1)``, as DeepSeek-V3's
inference code does.

Routing: each expert layer's own choice is the top ``k`` of
``sigmoid(h @ router) + bias``.  ``routes`` (S, expert layers, k), when
given, replaces those choices in the computation (the weights are still
the reference's own unbiased scores, normalised over the given ``k``
and scaled), so that a served run's choices at near-ties can be
followed; ``report`` then receives, per expert layer, the reference's
own choices and the margin between its ``k``-th and ``k+1``-th biased
score, for the caller to hold the served choices to where that margin is
wide.

This file is copied verbatim as ``benchmark/reference/mla_moe.py``; it
imports neither the port nor JAX.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def strict_fp32():
    """float32 products in float32 on a card (no TF32), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _f(t):
    return t.float()


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * _f(w)


def _rope(x, positions, dim, theta):
    """Rotate the interleaved pairs of ``x`` (S, ..., dim) at ``positions``."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim)
    ang = positions.float()[:, None] * inv  # (S, dim / 2)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (dim // 2,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1).flatten(-2)


def _swiglu(h, w_gate, w_up, w_down):
    """``h @ w_gate`` etc. with (in, out) matrices."""
    return (torch.nn.functional.silu(h @ _f(w_gate)) * (h @ _f(w_up))) @ _f(w_down)


def _attention(layer, h, cfg):
    S = h.shape[0]
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    n, r, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    pos = torch.arange(S, device=h.device)
    q = (h @ _f(layer["wq"])).view(S, H, n + r)
    q = torch.cat([q[..., :n], _rope(q[..., n:], pos, r, theta)], dim=-1)
    kv = h @ _f(layer["wkv_a"])
    c_kv = _rms_norm(kv[:, :R], layer["kv_norm"], eps)
    k_pe = _rope(kv[:, R:], pos, r, theta)
    kvb = (c_kv @ _f(layer["wkv_b"])).view(S, H, n + v)
    k = torch.cat([kvb[..., :n], k_pe[:, None, :].expand(S, H, r)], dim=-1)
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(n + r)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(torch.where(causal, scores, float("-inf")), dim=-1)
    o = torch.einsum("hst,thv->shv", p, kvb[..., n:]).reshape(S, H * v)
    return o @ _f(layer["wo"])


def _experts(layer, h, cfg, given, report):
    """The expert layer over ``h`` (S, d): routed experts by the
    reference's choice or by ``given`` (S, k), plus the shared expert."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(h @ _f(layer["router"]))
    biased = scores + _f(layer["bias"])
    top = torch.topk(biased, k + 1, dim=-1)
    own = top.indices[:, :k]
    if report is not None:
        report.append({"own": own, "margin": top.values[:, k - 1] - top.values[:, k]})
    use = own if given is None else given.long()
    w = scores.gather(-1, use)
    w = w / w.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
    out = _swiglu(h, layer["ws_gate"], layer["ws_up"], layer["ws_down"])
    for e in torch.unique(use).tolist():
        tok, slot = (use == e).nonzero(as_tuple=True)
        y = _swiglu(h[tok], layer["we_gate"][e].T, layer["we_up"][e].T, layer["we_down"][e].T)
        out = out.index_add(0, tok, y * w[tok, slot][:, None])
    return out


def forward(params, tokens, cfg: dict, routes=None, report=None):
    """Logits (S, V) float32 of ``tokens`` (S,), a sequence from
    position 0.  ``routes`` (S, expert layers, k) replaces the routed
    choices; ``report``, a list, receives per expert layer the
    reference's own choices (S, k) and its k-th to (k+1)-th margins (S,)."""
    eps = cfg["rms_norm_eps"]
    x = _f(params["embed"][tokens])
    j = 0
    for layer in params["layers"]:
        x = x + _attention(layer, _rms_norm(x, layer["attn_norm"], eps), cfg)
        h = _rms_norm(x, layer["ffn_norm"], eps)
        if "router" in layer:
            given = None if routes is None else routes[:, j]
            x = x + _experts(layer, h, cfg, given, report)
            j += 1
        else:
            x = x + _swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"])
    return _rms_norm(x, params["final_norm"], eps) @ _f(params["lm_head"])
