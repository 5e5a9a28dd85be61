"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of each kernel and step, counted from shapes.

Nothing here reads the program.  A model is the dict of widths that a
configuration file holds (``vocab``, ``d_model``, ``n_heads``, ``d_ff``,
``n_layers``, ``seq``, ``moe_experts``).  Bytes count each input byte
read once and each output byte written once; work that depends on the
data counts what the inputs need (the real tokens of a padded prompt,
the live rows of a batch, the positions each row attends).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peak:
    """Published dense peaks of one card (NVIDIA's data sheets)."""

    part: str
    bf16_flops: float  # FLOP/s on the tensor cores, bf16, no sparsity
    hbm_bytes_per_s: float


# NVIDIA H100 Tensor Core GPU data sheet, the SXM part at its full power
# limit: the card the benchmark runs on.
PEAKS = {"h100-sxm": Peak("h100-sxm", 989e12, 3.35e12)}


def peak_for(device_name: str) -> "Peak | None":
    """The peaks of a card named ``device_name``; None for a card not in
    the table (no share of a peak is then reported).  The SXM part names
    itself "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts say so."""
    low = device_name.lower()
    if "h100" in low and "hbm3" in low:
        return PEAKS["h100-sxm"]
    return None


def bound_s(flops: float, nbytes: float, peak: Peak) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak.bf16_flops, nbytes / peak.hbm_bytes_per_s)


# -- the model's parameters ---------------------------------------------------


def _attn_params(m: dict) -> int:
    d = m["d_model"]
    return 4 * d * d  # wqkv (d, 3d) and wo (d, d)


def _mlp_params(m: dict) -> int:
    return 2 * m["d_model"] * m["d_ff"]  # w1 and w2, one expert's or the dense MLP's


def param_count(m: dict) -> int:
    """Every parameter of the burn-in LM (embedding tied with the logits)."""
    d, L, E = m["d_model"], m["n_layers"], m.get("moe_experts", 0)
    mlp = E * _mlp_params(m) + d * E if E else _mlp_params(m)
    return m["vocab"] * d + m["seq"] * d + L * (_attn_params(m) + mlp + 2 * d) + d


def active_matmul_params(m: dict) -> int:
    """Weights one token multiplies through in the layers (top-1: one
    expert, plus the router), without the logits product."""
    E = m.get("moe_experts", 0)
    return m["n_layers"] * (_attn_params(m) + _mlp_params(m) + m["d_model"] * E)


def serve_weight_bytes(m: dict) -> int:
    """Bytes of weights a serving step reads, each at the width it is
    served in: the layer matrices bf16, every expert's (a decode batch
    sends tokens to each of them), the router f32, and the tied embedding
    f32 for the logits."""
    d, L, E = m["d_model"], m["n_layers"], m.get("moe_experts", 0)
    mlp = E * _mlp_params(m) if E else _mlp_params(m)
    return L * (_attn_params(m) + mlp) * 2 + L * d * E * 4 + m["vocab"] * d * 4


def kv_bytes_per_position(m: dict) -> int:
    """K and V of one position over every layer, bf16."""
    return m["n_layers"] * 2 * m["d_model"] * 2


# -- serving ---------------------------------------------------------------------


def decode_step(m: dict, contexts: "list[int]") -> "tuple[float, float]":
    """(flops, bytes) of one decode step whose live rows attend
    ``contexts`` positions each (the new token's included)."""
    d, L, V = m["d_model"], m["n_layers"], m["vocab"]
    rows = len(contexts)
    ctx = sum(contexts)
    flops = 2.0 * (active_matmul_params(m) + V * d) * rows + 4.0 * d * L * ctx
    nbytes = serve_weight_bytes(m) + kv_bytes_per_position(m) * ctx
    return flops, float(nbytes)


def prefill(m: dict, n: int) -> "tuple[float, float]":
    """(flops, bytes) of a prompt of ``n`` real tokens prefilled in one
    pass: the layers over every token, causal attention over each
    token's predecessors, the logits of the last position; the weights
    read once and the prompt's K and V written."""
    d, L, V = m["d_model"], m["n_layers"], m["vocab"]
    flops = 2.0 * active_matmul_params(m) * n + 4.0 * d * L * n * (n + 1) / 2 + 2.0 * V * d
    nbytes = serve_weight_bytes(m) + kv_bytes_per_position(m) * n
    return flops, float(nbytes)


def paged_attention_call(m: dict, contexts: "list[int]") -> "tuple[float, float]":
    """(flops, bytes) of one K1 launch (one layer) over the live rows:
    each context position's K and V read once, q read and out written."""
    hk = m["d_model"]  # heads x head width
    ctx = sum(contexts)
    flops = 4.0 * hk * ctx
    nbytes = 2 * hk * 2 * ctx + 2 * hk * 2 * len(contexts)
    return flops, float(nbytes)


# -- training --------------------------------------------------------------------


def train_step_flops(m: dict, batch: int, *, causal_half: bool = True) -> float:
    """Model FLOPs of one training step: the forward's products x3 for
    the forward and the backward, recompute not counted.  Causal
    attention counts half the s x s products; ``causal_half=False``
    counts them whole, as the reference package's MFU does."""
    b, s, d, f, L, V = batch, m["seq"], m["d_model"], m["d_ff"], m["n_layers"], m["vocab"]
    attn = 2 * b * s * s * d * 2 * (0.5 if causal_half else 1.0)
    per_layer = 2 * b * s * d * 3 * d + 2 * b * s * d * d + 2 * b * s * d * f * 2 + attn
    return 3.0 * (L * per_layer + 2 * b * s * d * V)


def flash_forward_call(batch: int, seq: int, heads: int, d_head: int) -> "tuple[float, float]":
    """(flops, bytes) of one causal K2 forward: the two products over the
    lower triangle; q, k, v read and o written, bf16."""
    flops = 2.0 * 2 * batch * heads * seq * seq * d_head / 2
    nbytes = 4 * batch * seq * heads * d_head * 2
    return flops, float(nbytes)
