"""Paged latent-attention decode (K3): the Triton kernel, its plain
version, the wrapper.

It replaces no TPU kernel: the JAX package has no latent attention.  It
was added for the DeepSeek-V3 block (`models.mla_moe`), whose decode
step attends in the absorbed form.  Each row's 16 heads read the same
latent cache: per position one 576-wide bf16 vector, the 512 normalised
``c_kv`` values and the 64 rotated ``k_pe`` values, in the paged pool's
blocks.  For row ``b`` and head ``h``, over the positions ``j <= pos[b]``
its block table names,

    score[h, j] = scale * (q[b, h, :512] . c_kv[j] + q[b, h, 512:] . k_pe[j])
    o_lat[b, h] = sum_j softmax(score[h])[j] * c_kv[j]

with ``q[b, h, :512]`` the query already taken through ``W_UK[h]``
(``q_lat``) and ``q[b, h, 512:]`` the rotated rope query.  The caller
takes ``o_lat`` through ``W_UV[h]``.

What bounds it on an H100: bytes.  A position costs 1,152 bytes of
latent and 2 x 16 x (576 + 512) FLOP, about 30 FLOP a byte against the
card's ridge near 295, so the least time is the live contexts' latent
bytes over 3.35 TB/s.  The design reads each latent tile once for all
heads: the 16 heads are one M=16 tile of both products, K and V are the
same tile (V is its first 512 columns).  A decode batch has about as
many rows as the card has SMs, and contexts differ in length, so each
row's blocks are split into ``S`` contiguous ranges, one program each
(flash-decoding's split).  The combine stays in the same launch: each
program writes its partial sums and bumps a per-row counter, and the
row's last program to arrive folds the ``S`` partials (softmax
rescaling by each part's maximum) and writes ``o_lat``.  The counter is
left at zero for the next launch, so one launch a layer does the whole
contraction.

- `mla_decode_plain`: the same function in plain PyTorch, block column
  by block column with the same online softmax and the same rounding
  point (the probabilities rounded to bf16 before their product with
  ``c_kv``).  The CPU runs it; the card holds the kernel against it.
- `mla_decode`: the public entry.  CPU tensors go to the plain version;
  CUDA tensors launch the kernel (and bump ``mla_decode.launches``; a
  launch recorded into a CUDA graph is not counted, and `note_replays`
  counts the graph's replays instead); anything else raises.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import torch

__all__ = ["mla_decode", "mla_decode_plain", "note_replays", "split_count"]

_NEG = -1.0e30
# The card's SMs: enough programs are launched to give each about two.
_SMS = 132
_MAX_SPLITS = 16
# Positions a program's tile holds, and its warps: the fastest of six
# tried on an H100 at 128 rows with contexts to 1,200 and to 2,816
# (BLOCK_N 16 to 128, 4 or 8 warps).
BLOCK_N = 64
WARPS = 8

_LOCK = threading.Lock()
# (device index, stream) -> int32 per-row arrival counters, left zeroed
# by every launch.
_COUNTERS: "dict[tuple[int, int], torch.Tensor]" = {}


def _count_launch() -> None:
    with _LOCK:
        mla_decode.launches += 1


def note_replays(n: int) -> None:
    """Count ``n`` launches run by replaying captured CUDA graphs."""
    with _LOCK:
        mla_decode.launches += n


def split_count(rows: int, max_blocks: int) -> int:
    """Programs a row's blocks are split over: a power of two that gives
    the card about two programs an SM, at most `_MAX_SPLITS` and no more
    than the table's columns."""
    want = max(1, -(-2 * _SMS // max(rows, 1)))
    s = 1
    while s < want and s < _MAX_SPLITS and s < max_blocks:
        s *= 2
    return s


def _check(q, pool, table, pos):
    if q.dim() != 3 or pool.dim() != 3:
        raise ValueError(
            f"q must be (B, H, D) and a layer's pool (NB, W, D), got {tuple(q.shape)} "
            f"and {tuple(pool.shape)}"
        )
    if q.shape[-1] != pool.shape[-1]:
        raise ValueError(f"q and the pool differ in width: {q.shape[-1]} vs {pool.shape[-1]}")
    if table.dim() != 2 or table.shape[0] != q.shape[0] or pos.shape != (q.shape[0],):
        raise ValueError("table must be (B, NW) and pos (B,) for q's B rows")
    if q.dtype != torch.bfloat16 or pool.dtype != torch.bfloat16:
        raise TypeError("q and the pool are bf16")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("table and pos are int32")


def mla_decode_plain(q, pool, table, pos, *, v_dim: int, scale: float):
    """The contraction in plain PyTorch, block column by block column:
    ``q`` (B, H, D) bf16, a layer's ``pool`` (NB, W, D) bf16, ``table``
    (B, NW) int32, ``pos`` (B,) int32.  Returns ``o_lat`` (B, H, v_dim)
    f32, the softmax-weighted sum of each position's first ``v_dim``
    values."""
    _check(q, pool, table, pos)
    B, H, _ = q.shape
    W = pool.shape[1]
    qf = q.float()
    m = torch.full((B, H), _NEG, device=q.device)
    denom = torch.zeros((B, H), device=q.device)
    acc = torch.zeros((B, H, v_dim), device=q.device)
    for col in range(table.shape[1]):
        blk = pool[table[:, col].long()]  # (B, W, D) bf16
        tok = col * W + torch.arange(W, device=q.device)
        valid = tok[None, :] <= pos[:, None].long()  # (B, W)
        s = torch.einsum("bhd,bwd->bhw", qf, blk.float()) * scale
        s = torch.where(valid[:, None, :], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(-1)
        pv = torch.einsum("bhw,bwd->bhd", p.to(torch.bfloat16).float(), blk[..., :v_dim].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    return acc / denom[..., None]


def mla_decode(q, pool, table, pos, *, v_dim: int, scale: float):
    """`mla_decode_plain`'s function: the plain version for CPU tensors,
    the kernel (one launch) for CUDA tensors."""
    if q.device.type == "cpu":
        return mla_decode_plain(q, pool, table, pos, v_dim=v_dim, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode runs on the CPU or a CUDA card, not {q.device}")
    _check(q, pool, table, pos)
    if not (q.is_contiguous() and pool.stride(-1) == 1 and table.is_contiguous()):
        raise ValueError("q and table must be contiguous and the pool's last dim dense")
    return _launch(q, pool, table, pos, v_dim, scale)


mla_decode.launches = 0


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _counters(dev: torch.device, rows: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < rows:
            buf = torch.zeros(max(rows, 256), dtype=torch.int32, device=dev)
            _COUNTERS[key] = buf
    return buf


def _launch(q, pool, table, pos, v_dim: int, scale: float):
    kernel = _kernel()
    B, H, D = q.shape
    NB, W, _ = pool.shape
    dr = D - v_dim
    if _pow2(v_dim) != v_dim or _pow2(dr) != dr or W % 32 or W % min(BLOCK_N, W):
        raise ValueError(
            f"the kernel takes power-of-two latent and rope widths and blocks of a multiple "
            f"of 32 tokens, got {v_dim}, {dr} and W={W}"
        )
    hp = max(16, _pow2(H))
    S = split_count(B, table.shape[1])
    out = torch.empty((B, H, v_dim), dtype=torch.float32, device=q.device)
    part_o = torch.empty((B, S, H, v_dim), dtype=torch.float32, device=q.device) if S > 1 else out
    part_ml = torch.empty((B, S, 2, H), dtype=torch.float32, device=q.device) if S > 1 else out
    counters = _counters(q.device, B)
    kernel[(B, S)](
        q, pool, table, pos, out, part_o, part_ml, counters,
        q.stride(0), q.stride(1), pool.stride(0), pool.stride(1), table.stride(0),
        float(scale),
        H=H, HP=hp, DL=v_dim, DR=dr, W=W, S=S, BLOCK_N=min(BLOCK_N, W),
        num_warps=WARPS, num_stages=2,
    )
    if not torch.cuda.is_current_stream_capturing():
        _count_launch()
    return out


_KERNEL = None


def _kernel():
    """The Triton kernel, built at first use (the CPU has no Triton).
    Triton's cache stays inside the checkout, in ``build/triton`` beside
    the CUDA kernels' libraries (`_build`), unless the caller set one."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    os.environ.setdefault("TRITON_CACHE_DIR", str(Path(__file__).parent / "build" / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _mla_decode_kernel(q_ptr, pool_ptr, table_ptr, pos_ptr, out_ptr, part_o_ptr,
                           part_ml_ptr, count_ptr, sq_b, sq_h, sp_n, sp_w, st_b, scale,
                           H: tl.constexpr, HP: tl.constexpr, DL: tl.constexpr,
                           DR: tl.constexpr, W: tl.constexpr, S: tl.constexpr,
                           BLOCK_N: tl.constexpr):
        b = tl.program_id(0)
        s = tl.program_id(1)
        offs_h = tl.arange(0, HP)
        offs_l = tl.arange(0, DL)
        offs_r = tl.arange(0, DR)
        offs_n = tl.arange(0, BLOCK_N)
        hmask = offs_h < H
        qrow = q_ptr + b * sq_b + offs_h[:, None] * sq_h
        ql = tl.load(qrow + offs_l[None, :], mask=hmask[:, None], other=0.0)
        qr = tl.load(qrow + DL + offs_r[None, :], mask=hmask[:, None], other=0.0)
        n_tok = tl.load(pos_ptr + b) + 1
        n_blk = tl.cdiv(n_tok, W)
        per = tl.cdiv(n_blk, S)
        lo = s * per
        hi = tl.minimum(lo + per, n_blk)
        m = tl.full([HP], -1.0e30, tl.float32)
        den = tl.zeros([HP], tl.float32)
        acc = tl.zeros([HP, DL], tl.float32)
        for blk in range(lo, hi):
            phys = tl.load(table_ptr + b * st_b + blk).to(tl.int64)
            for t0 in tl.static_range(0, W, BLOCK_N):
                tok = blk * W + t0 + offs_n
                valid = tok < n_tok
                row = pool_ptr + phys * sp_n + (t0 + offs_n)[:, None] * sp_w
                c = tl.load(row + offs_l[None, :], mask=valid[:, None], other=0.0)
                r = tl.load(row + DL + offs_r[None, :], mask=valid[:, None], other=0.0)
                sc = tl.dot(ql, tl.trans(c)) + tl.dot(qr, tl.trans(r))
                sc = tl.where(valid[None, :], sc * scale, float("-inf"))
                m_new = tl.maximum(m, tl.max(sc, 1))
                alpha = tl.exp(m - m_new)
                p = tl.exp(sc - m_new[:, None])
                den = den * alpha + tl.sum(p, 1)
                acc = acc * alpha[:, None] + tl.dot(p.to(tl.bfloat16), c)
                m = m_new
        out_rows = out_ptr + b * (H * DL) + offs_h[:, None] * DL + offs_l[None, :]
        if S == 1:
            tl.store(out_rows, acc / den[:, None], mask=hmask[:, None])
        else:
            part = part_o_ptr + (b * S + s) * (H * DL) + offs_h[:, None] * DL + offs_l[None, :]
            tl.store(part, acc, mask=hmask[:, None])
            ml = part_ml_ptr + (b * S + s) * (2 * H)
            tl.store(ml + offs_h, m, mask=hmask)
            tl.store(ml + H + offs_h, den, mask=hmask)
            # Every thread's partial stores before the arrival.
            tl.debug_barrier()
            arrived = tl.atomic_add(count_ptr + b, 1, sem="acq_rel")
            if arrived == S - 1:
                offs_s = tl.arange(0, S)
                mls = part_ml_ptr + b * S * (2 * H) + offs_s[:, None] * (2 * H) + offs_h[None, :]
                ms = tl.load(mls, mask=hmask[None, :], other=-1.0e30, cache_modifier=".cg")
                ds = tl.load(mls + H, mask=hmask[None, :], other=0.0, cache_modifier=".cg")
                mx = tl.max(ms, 0)
                wts = tl.exp(ms - mx[None, :])  # (S, HP)
                total = tl.sum(wts * ds, 0)
                res = tl.zeros([HP, DL], tl.float32)
                for j in tl.static_range(0, S):
                    pj = (part_o_ptr + (b * S + j) * (H * DL) + offs_h[:, None] * DL
                          + offs_l[None, :])
                    oj = tl.load(pj, mask=hmask[:, None], other=0.0, cache_modifier=".cg")
                    mj = tl.load(part_ml_ptr + (b * S + j) * (2 * H) + offs_h, mask=hmask,
                                 other=-1.0e30, cache_modifier=".cg")
                    res += oj * tl.exp(mj - mx)[:, None]
                tl.store(out_rows, res / total[:, None], mask=hmask[:, None])
                tl.store(count_ptr + b, 0)

    _KERNEL = _mla_decode_kernel
    return _KERNEL
