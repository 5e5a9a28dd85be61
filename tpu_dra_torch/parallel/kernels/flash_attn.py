"""Flash attention forward: the CUDA kernel, its plain version, the wrapper.

Counterpart of the forward of `tpu_dra.parallel.flash.flash_attention`
(a Pallas kernel on the TPU; one hand-written CUDA kernel here,
``csrc/flash_attn.cu``, whose header says what bounds it and what its
design does about that).  Causal or full softmax attention of q
(b, s, h, d) against k, v of the same shape with the online softmax: f32
scores of ``q * (1/sqrt(d))``, f32 probabilities into the V product, the
output ``acc / max(l, 1e-30)`` cast to q's dtype.

- `flash_attention_plain`: the same online softmax in plain PyTorch, tile
  by tile in f32.  The CPU runs it, and the card holds the kernel
  against it.
- `flash_attention_forward`: the entry.  CPU tensors go to the plain
  version; CUDA tensors launch the kernel (and bump
  ``flash_attention_forward.launches``); anything else raises.  Nothing
  falls back: a kernel that does not build or launch is an error.

The gradient is not here: `tpu_dra_torch.parallel.flash.flash_attention`
wraps this forward in an autograd Function.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention_forward", "flash_attention_plain"]

_NEG_INF = -1e30
_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128)  # the widths the kernel is instantiated for


def _check(q, k, v, block_q: int, block_k: int):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k and v must be (b, s, h, d) of one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"q, k and v must share one dtype of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    s = q.shape[1]
    if s % block_q or s % block_k:
        raise ValueError(
            f"block_q={block_q} and block_k={block_k} must divide sequence length {s}"
        )
    return q.shape


def flash_attention_plain(q, k, v, causal: bool = True, block_q: int = 128, block_k: int = 128):
    """The reference's flash forward in plain PyTorch: for each query
    tile, fold the key tiles up to the causal diagonal into the running
    ``(m, l, acc)`` in f32 (tiles wholly in the future are skipped), then
    ``acc / max(l, 1e-30)`` in q's dtype.  Shapes as the entry; returns a
    contiguous (b, s, h, d)."""
    b, s, h, d = _check(q, k, v, block_q, block_k)
    scale = 1.0 / (d ** 0.5)
    qf = q.float().transpose(1, 2) * scale  # (b, h, s, d)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    pos = torch.arange(s, device=q.device)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, s, block_q):
        qb = qf[:, :, q0:q0 + block_q]
        m = torch.full((b, h, block_q, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, block_q, 1), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for k0 in range(0, s, block_k):
            if causal and k0 > q0 + block_q - 1:
                break
            sc = qb @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
            if causal:
                vis = pos[q0:q0 + block_q, None] >= pos[None, k0:k0 + block_k]
                sc = torch.where(vis, sc, _NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, k0:k0 + block_k]
            m = m_new
        out[:, :, q0:q0 + block_q] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.transpose(1, 2).contiguous()


_SIGNATURE = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)


def _library():
    from tpu_dra_torch.parallel.kernels import _build

    lib = _build.load("flash_attn")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _SIGNATURE
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _launch(q, k, v, causal: bool):
    b, s, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes d in {_HEAD_DIMS}, got {d}")
    esize = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(
                f"{name} must have contiguous head and feature dims (strides (.., .., {d}, 1)), "
                f"got strides {t.stride()}"
            )
        if t.data_ptr() % 16 or (t.stride(0) * esize) % 16 or (t.stride(1) * esize) % 16:
            raise ValueError(f"{name} must be 16-byte aligned at every row for vector loads")
    lib = _library()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            int(causal), int(q.dtype == torch.bfloat16), 1.0 / (d ** 0.5), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention_forward.launches += 1
    return out


def flash_attention_forward(q, k, v, causal: bool = True, block_q: int = 128,
                            block_k: int = 128):
    """Softmax attention of q (b, s, h, d) against k, v of the same shape
    and dtype (bf16 or f32); returns a contiguous (b, s, h, d) in that
    dtype.  ``block_q``/``block_k`` must divide s: the plain version tiles
    by them; the kernel keeps its own 64 x 64 tiles.

    CPU tensors run `flash_attention_plain`; CUDA tensors launch the
    kernel (d 64 or 128; q, k and v may be strided views of one qkv
    tensor as long as their head and feature dims are contiguous) and
    count the launch in ``flash_attention_forward.launches``; mixed or
    other devices raise."""
    _check(q, k, v, block_q, block_k)
    kinds = {t.device.type for t in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_attention_plain(q, k, v, causal, block_q, block_k)
    if kinds == {"cuda"} and len({t.device for t in (q, k, v)}) == 1:
        return _launch(q, k, v, causal)
    raise ValueError(
        f"flash_attention takes q, k and v all on the CPU or all on one CUDA device, "
        f"got {[str(t.device) for t in (q, k, v)]}"
    )


flash_attention_forward.launches = 0
