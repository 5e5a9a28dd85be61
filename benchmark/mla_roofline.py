"""The yardstick's arithmetic for a DeepSeek-V3-block model (latent
attention, top-k experts with shared experts): the operations and bytes
of its serving steps and of K3, the paged latent-attention decode
kernel, counted from shapes.

Nothing here reads the program.  A model is the dict of a configuration
file's published keys (``hidden_size``, ``num_attention_heads``,
``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
``v_head_dim``, ``intermediate_size``, ``moe_intermediate_size``,
``n_routed_experts``, ``n_shared_experts``, ``num_experts_per_tok``,
``first_k_dense_replace``, ``num_hidden_layers``, ``vocab_size``).
Bytes count each input byte read once and each output written once, at
the width it is served in (matrices and the latent cache bf16, the
router f32); work that depends on the data counts what the inputs need:
the live rows, the positions each attends, and of the routed experts
those a step's tokens can be expected to reach.
"""

from __future__ import annotations


def _widths(m: dict):
    return (m["hidden_size"], m["num_attention_heads"], m["kv_lora_rank"],
            m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"])


def attn_params(m: dict) -> int:
    """One layer's attention matrices: wq, wkv_a, wkv_b and wo."""
    d, H, R, n, r, v = _widths(m)
    return d * H * (n + r) + d * (R + r) + R * H * (n + v) + H * v * d


def expert_params(m: dict) -> int:
    """One routed expert's SwiGLU."""
    return 3 * m["hidden_size"] * m["moe_intermediate_size"]


def shared_params(m: dict) -> int:
    return expert_params(m) * m["n_shared_experts"]


def dense_params(m: dict) -> int:
    return 3 * m["hidden_size"] * m["intermediate_size"]


def _layers(m: dict) -> "tuple[int, int]":
    dense = m["first_k_dense_replace"]
    return dense, m["num_hidden_layers"] - dense


def active_params(m: dict) -> int:
    """Matrix weights one token multiplies through, the logits included:
    every layer's attention, the dense layers' SwiGLU, and in each expert
    layer the router, ``k`` routed experts and the shared ones."""
    dense, moe = _layers(m)
    d, E, k = m["hidden_size"], m["n_routed_experts"], m["num_experts_per_tok"]
    per_moe = d * E + k * expert_params(m) + shared_params(m)
    return (m["num_hidden_layers"] * attn_params(m) + dense * dense_params(m) + moe * per_moe
            + m["vocab_size"] * d)


def experts_reached(m: dict, tokens: int) -> float:
    """Routed experts a layer can be expected to read for ``tokens``
    tokens, each choosing ``k`` of ``E`` at random: ``E * (1 - ((E - k)
    / E) ** tokens)`` (at 128 decode rows of Moonlight, all 64)."""
    E, k = m["n_routed_experts"], m["num_experts_per_tok"]
    return E * (1.0 - ((E - k) / E) ** tokens)


def weight_bytes(m: dict, tokens: int) -> float:
    """Weights a pass of ``tokens`` tokens reads: every dense matrix
    bf16, the router f32, the routed experts it reaches, and the logits'
    matrix (the embedding's rows are gathered, not read whole)."""
    dense, moe = _layers(m)
    d, E = m["hidden_size"], m["n_routed_experts"]
    per_moe = 2 * (experts_reached(m, tokens) * expert_params(m) + shared_params(m)) + 4 * d * E
    return (2 * m["num_hidden_layers"] * attn_params(m) + 2 * dense * dense_params(m)
            + moe * per_moe + 2 * m["vocab_size"] * d)


def latent_bytes_per_position(m: dict) -> int:
    """One position's latent cache over every layer, bf16."""
    return m["num_hidden_layers"] * (m["kv_lora_rank"] + m["qk_rope_head_dim"]) * 2


def decode_step(m: dict, contexts: "list[int]") -> "tuple[float, float]":
    """(flops, bytes) of one decode step whose live rows attend
    ``contexts`` positions each (the new token's included), in the
    absorbed form: per head and position a product of the latent and
    rope query (R + r) and one of the latent value (R)."""
    _, H, R, _, r, _ = _widths(m)
    rows, ctx = len(contexts), sum(contexts)
    L = m["num_hidden_layers"]
    flops = 2.0 * active_params(m) * rows + 2.0 * H * (2 * R + r) * L * ctx
    nbytes = weight_bytes(m, rows) + latent_bytes_per_position(m) * (ctx + rows)
    return flops, float(nbytes)


def prefill(m: dict, n: int) -> "tuple[float, float]":
    """(flops, bytes) of a prompt of ``n`` real tokens in one pass, the
    expanded form: the layers over every token (the latent's expansion
    through wkv_b once a position), causal attention over each token's
    predecessors, the logits of the last position only; the weights read
    once and the prompt's latents written."""
    _, H, _, n_, r, v = _widths(m)
    L, V, d = m["num_hidden_layers"], m["vocab_size"], m["hidden_size"]
    flops = (2.0 * (active_params(m) - V * d) * n + 2.0 * H * (n_ + r + v) * L * n * (n + 1) / 2
             + 2.0 * V * d)
    nbytes = weight_bytes(m, n) + latent_bytes_per_position(m) * n
    return flops, float(nbytes)


def k3_call(m: dict, contexts: "list[int]") -> "tuple[float, float]":
    """(flops, bytes) of one K3 launch (one layer) over the live rows:
    each context position's latent (R + r values, bf16) read once, each
    row's 16-head query (R + r, bf16) read and ``o_lat`` (R, f32)
    written."""
    _, H, R, _, r, _ = _widths(m)
    ctx = sum(contexts)
    flops = 2.0 * H * (2 * R + r) * ctx
    nbytes = 2 * (R + r) * ctx + len(contexts) * H * (2 * (R + r) + 4 * R)
    return flops, float(nbytes)
