"""Paged decode attention: the CUDA kernel, its plain version, the wrapper.

Counterpart of `tpu_dra.parallel.kernels.paged_attn.paged_attention`
(two Pallas passes on the TPU; one hand-written CUDA kernel here,
``csrc/paged_attn.cu``, whose header says what bounds it and what its
design does about that).  Row ``b``'s single query ``q[b]`` attends the
positions ``j <= pos[b]`` of the context its block table names, reading
each physical block through the table — the ``(B, NW*W, H, K)`` gather
of the dense path never materializes.

- `paged_attention_plain`: the same two-pass function in plain PyTorch,
  block column by block column, with the reference's rounding points.
  The CPU runs it, and the card holds the kernel against it.
- `paged_attention`: the public entry.  CPU tensors go to the plain
  version; CUDA tensors launch the kernel (and bump
  ``paged_attention.launches``); anything else raises.  Nothing falls
  back: a kernel that does not build or launch is an error.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_dra_torch.parallel.burnin import bf16_scalar

__all__ = ["paged_attention", "paged_attention_plain"]

_NEG_INF = -1e30


def _sqrt_d(K: int) -> float:
    # The reference divides bf16 scores by a weakly typed Python float,
    # which JAX rounds to bf16 first.
    return bf16_scalar(K ** 0.5)


def _check_shapes(q, k_pool, v_pool, table, pos):
    if isinstance(k_pool, dict) or isinstance(v_pool, dict):
        raise TypeError(
            "int8 {'q','s'} pools are not ported yet: paged_attention takes "
            "bf16 pool leaves"
        )
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool leaves must both be (NB, W, H, K) per layer, got "
            f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}"
        )
    _, W, H, K = k_pool.shape
    if table.dim() != 2:
        raise ValueError(f"table must be (B, NW), got {tuple(table.shape)}")
    B, NW = table.shape
    if tuple(q.shape) != (B, H, K):
        raise ValueError(f"q must be (B, H, K) = ({B}, {H}, {K}), got {tuple(q.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")
    return B, NW, W, H, K


def paged_attention_plain(q, k_pool, v_pool, table, pos):
    """The two-pass paged attention in plain PyTorch, one table column at
    a time (the TPU grid's block axis as a loop, rows and heads as batch
    dims).  Pass 1 folds each block's scores into the online-softmax
    ``(m, l)``; pass 2 adds ``bf16(exp(s - m) / l) @ v`` into an f32
    accumulator.  Blocks wholly past a row's position are skipped.
    Shapes as `paged_attention`; returns (B, H, K) bf16."""
    B, NW, W, H, K = _check_shapes(q, k_pool, v_pool, table, pos)
    dev = q.device
    qf = q.float()
    sqrt_d = _sqrt_d(K)
    offs = torch.arange(W, device=dev)
    pos = pos.long()

    def block(j, pool):
        return pool[table[:, j].long()].float()  # (B, W, H, K)

    def scores(j):
        s = torch.einsum("bhk,bwhk->bhw", qf, block(j, k_pool))
        s = (s.to(torch.bfloat16) / sqrt_d).float()
        vis = (j * W + offs)[None, :] <= pos[:, None]  # (B, W)
        return torch.where(vis[:, None, :], s, _NEG_INF), vis[:, None, :]

    m = torch.full((B, H, 1), _NEG_INF, device=dev)
    l = torch.zeros((B, H, 1), device=dev)
    for j in range(NW):
        live = (j * W <= pos)[:, None, None]  # (B, 1, 1)
        s, vis = scores(j)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        pexp = torch.where(vis, torch.exp(s - m_new), 0.0)
        l_new = l * torch.exp(m - m_new) + pexp.sum(-1, keepdim=True)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)

    l = torch.clamp(l, min=1e-30)
    acc = torch.zeros((B, H, K), device=dev)
    for j in range(NW):
        live = (j * W <= pos)[:, None, None]
        s, vis = scores(j)
        probs = (torch.where(vis, torch.exp(s - m), 0.0) / l).to(torch.bfloat16)
        part = torch.einsum("bhw,bwhk->bhk", probs.float(), block(j, v_pool))
        acc = acc + torch.where(live, part, 0.0)
    return acc.to(torch.bfloat16)


_SIGNATURE = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
)
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory one Hopper block may use


def _library():
    from tpu_dra_torch.parallel.kernels import _build

    lib = _build.load("paged_attn")
    if lib.paged_attention_bf16.argtypes is None:
        lib.paged_attention_bf16.argtypes = _SIGNATURE
        lib.paged_attention_bf16.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _launch(q, k_pool, v_pool, table, pos, dims):
    B, NW, W, H, K = dims
    for name, t, dtype in (
        ("q", q, torch.bfloat16), ("k_pool", k_pool, torch.bfloat16),
        ("v_pool", v_pool, torch.bfloat16), ("table", table, torch.int32),
        ("pos", pos, torch.int32),
    ):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if K % 8 or (K // 8) & (K // 8 - 1) or K // 8 > 32:
        raise ValueError(f"the kernel takes K in (8, 16, 32, 64, 128, 256), got {K}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")
    lib = _library()
    smem = lib.paged_attention_smem_bytes(K, W, NW)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"a table reach of {NW * W} positions needs {smem} bytes of "
            f"shared memory, over the {_SMEM_LIMIT} a block may use"
        )
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, H, K, W, NW, _sqrt_d(K), stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pool, v_pool, table, pos):
    """One decode step's attention for B rows straight off the block pool.

    ``q``: (B, H, K) bf16, the already-rotated per-row queries.
    ``k_pool``/``v_pool``: one LAYER's pool leaves, (NB, W, H, K) bf16.
    ``table``: (B, NW) int32 physical block ids (0 = scratch, never
    visible).  ``pos``: (B,) int32 per-row positions.  Returns (B, H, K)
    bf16.

    CPU tensors run `paged_attention_plain`; CUDA tensors launch the
    kernel and count the launch in ``paged_attention.launches``; int8
    pools and any other device raise."""
    dims = _check_shapes(q, k_pool, v_pool, table, pos)
    kinds = {t.device.type for t in (q, k_pool, v_pool, table, pos)}
    if kinds == {"cpu"}:
        return paged_attention_plain(q, k_pool, v_pool, table, pos)
    if kinds == {"cuda"}:
        return _launch(q, k_pool, v_pool, table, pos, dims)
    raise ValueError(
        f"paged_attention takes tensors all on the CPU or all on CUDA, got {sorted(kinds)}"
    )


paged_attention.launches = 0
