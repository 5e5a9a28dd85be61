"""Paged decode attention: the CUDA kernel, its plain version, the wrapper.

Counterpart of `tpu_dra.parallel.kernels.paged_attn.paged_attention`
(two Pallas passes on the TPU; one hand-written CUDA kernel here,
``csrc/paged_attn.cu``, whose header says what bounds it and what its
design does about that).  Row ``b``'s single query ``q[b]`` attends the
positions ``j <= pos[b]`` of the context its block table names, reading
each physical block through the table — the ``(B, NW*W, H, K)`` gather
of the dense path never materializes.  The pools are bf16, or int8
``{"q": (NB, W, H, K) int8, "s": (NB, W, H, 1) f32}`` pairs, whose
blocks are dequantized as they are read: ``bf16(f32(q) * s)``, the
reference's ``_block_kv``.

- `paged_attention_plain`: the same two-pass function in plain PyTorch,
  block column by block column, with the reference's rounding points.
  The CPU runs it, and the card holds the kernel against it.
- `paged_attention`: the public entry.  CPU tensors go to the plain
  version; CUDA tensors launch the kernel's bf16 or int8 form (and bump
  ``paged_attention.launches``); anything else raises.  Nothing falls
  back: a kernel that does not build or launch is an error, and an int8
  pool is never dequantized for the bf16 form.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_dra_torch.parallel.burnin import bf16_scalar
from tpu_dra_torch.parallel.quant import is_quantized_leaf

__all__ = ["paged_attention", "paged_attention_plain"]

_NEG_INF = -1e30


def _sqrt_d(K: int) -> float:
    # The reference divides bf16 scores by a weakly typed Python float,
    # which JAX rounds to bf16 first.
    return bf16_scalar(K ** 0.5)


def _is_int8(pool) -> bool:
    if is_quantized_leaf(pool):
        return True
    if not torch.is_tensor(pool):
        raise TypeError(f"a pool is a tensor or an int8 {{'q','s'}} pair, got {type(pool).__name__}")
    return False


def _check_shapes(q, k_pool, v_pool, table, pos):
    """The call's dims ``(B, NW, W, H, K, int8)``, or a raise."""
    int8 = _is_int8(k_pool)
    if _is_int8(v_pool) != int8:
        raise TypeError(
            "k_pool and v_pool must both be bf16 tensors or both int8 "
            "{'q','s'} pairs, not one of each"
        )
    kq, vq = (k_pool["q"], v_pool["q"]) if int8 else (k_pool, v_pool)
    if kq.dim() != 4 or vq.shape != kq.shape:
        raise ValueError(
            f"pool leaves must both be (NB, W, H, K) per layer, got "
            f"{tuple(kq.shape)} and {tuple(vq.shape)}"
        )
    _, W, H, K = kq.shape
    if int8:
        want = (*kq.shape[:-1], 1)
        for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
            if tuple(pool["s"].shape) != want:
                raise ValueError(
                    f"{name}['s'] must be (NB, W, H, 1) = {want}, got {tuple(pool['s'].shape)}"
                )
    if table.dim() != 2:
        raise ValueError(f"table must be (B, NW), got {tuple(table.shape)}")
    B, NW = table.shape
    if tuple(q.shape) != (B, H, K):
        raise ValueError(f"q must be (B, H, K) = ({B}, {H}, {K}), got {tuple(q.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")
    return B, NW, W, H, K, int8


def paged_attention_plain(q, k_pool, v_pool, table, pos):
    """The two-pass paged attention in plain PyTorch, one table column at
    a time (the TPU grid's block axis as a loop, rows and heads as batch
    dims).  Pass 1 folds each block's scores into the online-softmax
    ``(m, l)``; pass 2 adds ``bf16(exp(s - m) / l) @ v`` into an f32
    accumulator.  Blocks wholly past a row's position are skipped.
    Shapes as `paged_attention`; returns (B, H, K) bf16."""
    B, NW, W, H, K, int8 = _check_shapes(q, k_pool, v_pool, table, pos)
    dev = q.device
    qf = q.float()
    sqrt_d = _sqrt_d(K)
    offs = torch.arange(W, device=dev)
    pos = pos.long()

    def block(j, pool):
        idx = table[:, j].long()
        if int8:  # the reference's rounding point: bf16(f32(q) * s)
            return (pool["q"][idx].float() * pool["s"][idx]).to(torch.bfloat16).float()
        return pool[idx].float()  # (B, W, H, K)

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


def _signature(n_ptrs: int):
    # n_ptrs pointers, then B, H, K, W, NW, sqrt_d and the stream.
    return [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


_SIGNATURES = {"paged_attention_bf16": _signature(6), "paged_attention_int8": _signature(8)}
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory one Hopper block may use
_MAX_GRID_Y = 65535  # the grid's second dimension: one (row, head) each


def _library():
    from tpu_dra_torch.parallel.kernels import _build

    lib = _build.load("paged_attn")
    if lib.paged_attention_smem_bytes.argtypes is None:
        for name, signature in _SIGNATURES.items():
            getattr(lib, name).argtypes = signature
            getattr(lib, name).restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_clusters.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.paged_attention_clusters.restype = ctypes.c_int
    return lib


def cluster_occupancy(B: int, H: int, K: int, W: int, NW: int) -> "tuple[int, int]":
    """``(clusters, resident)``: how many thread-block clusters the
    kernel's launch for these dims has, and how many of them the card
    holds at once (a launch of more runs in waves).  Needs CUDA."""
    grid = ctypes.c_int(0)
    resident = _library().paged_attention_clusters(B, H, K, W, NW, ctypes.byref(grid))
    if resident < 0:
        raise RuntimeError(f"paged_attention occupancy query failed: CUDA error {-resident}")
    return grid.value, resident


def _launch(q, k_pool, v_pool, table, pos, dims):
    B, NW, W, H, K, int8 = dims
    # (name, tensor, dtype, alignment in bytes the kernel's loads need)
    if int8:
        pools = [
            (f"{n}['{leaf}']", pool[leaf], dtype, align)
            for n, pool in (("k_pool", k_pool), ("v_pool", v_pool))
            for leaf, dtype, align in (("q", torch.int8, 8), ("s", torch.float32, 4))
        ]
    else:
        pools = [("k_pool", k_pool, torch.bfloat16, 16), ("v_pool", v_pool, torch.bfloat16, 16)]
    operands = [
        ("q", q, torch.bfloat16, 16), *pools,
        ("table", table, torch.int32, 4), ("pos", pos, torch.int32, 4),
    ]
    for name, t, dtype, align in operands:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned for the kernel's loads")
    if K % 8 or (K // 8) & (K // 8 - 1) or K // 8 > 32:
        raise ValueError(f"the kernel takes K in (8, 16, 32, 64, 128, 256), got {K}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(
            f"the kernel takes B * H <= {_MAX_GRID_Y} (one cluster of blocks each), got {B * H}"
        )
    lib = _library()
    smem = lib.paged_attention_smem_bytes(H, K, W, NW)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"a table reach of {NW * W} positions needs {smem} bytes of shared memory "
            f"in each block of its cluster, over the {_SMEM_LIMIT} a block may use"
        )
    out = torch.empty_like(q)
    fn = lib.paged_attention_int8 if int8 else lib.paged_attention_bf16
    pool_ptrs = [t.data_ptr() for _, t, _, _ in pools]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            q.data_ptr(), *pool_ptrs, table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, H, K, W, NW, _sqrt_d(K), stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pool, v_pool, table, pos):
    """One decode step's attention for B rows straight off the block pool.

    ``q``: (B, H, K) bf16, the already-rotated per-row queries.
    ``k_pool``/``v_pool``: one LAYER's pool leaves, both (NB, W, H, K)
    bf16 or both int8 pairs ``{"q": (NB, W, H, K) int8, "s": (NB, W, H,
    1) f32}``.  ``table``: (B, NW) int32 physical block ids (0 = scratch,
    never visible).  ``pos``: (B,) int32 per-row positions.  Returns (B,
    H, K) bf16.

    CPU tensors run `paged_attention_plain`; CUDA tensors launch the
    kernel's form for the pools' type and count the launch in
    ``paged_attention.launches``; a mixed pair or any other device
    raises."""
    dims = _check_shapes(q, k_pool, v_pool, table, pos)
    int8 = dims[-1]
    leaves = [t for pool in (k_pool, v_pool) for t in (pool.values() if int8 else [pool])]
    kinds = {t.device.type for t in (q, *leaves, table, pos)}
    if kinds == {"cpu"}:
        return paged_attention_plain(q, k_pool, v_pool, table, pos)
    if kinds == {"cuda"}:
        return _launch(q, k_pool, v_pool, table, pos, dims)
    raise ValueError(
        f"paged_attention takes tensors all on the CPU or all on CUDA, got {sorted(kinds)}"
    )


paged_attention.launches = 0
