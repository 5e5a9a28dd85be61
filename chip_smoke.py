#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpu_dra_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each asserted; any failure exits non-zero and prints no result:

1. card: its name and power limit; bf16 reduced-precision reductions
   and TF32 switched off (the reference never reduces in bf16);
2. build: every CUDA kernel of the package, from the sources in this
   checkout, one ``nvcc`` per source, all started together;
3. kernels: the paged-attention kernel held against its plain PyTorch
   version at the serving engine's shapes and at one odd small shape;
   a second call and masked-tail poisoning must leave the output
   bitwise unchanged; the kernel and the plain version timed with CUDA
   events (median of 100 launches, L2 flushed between launches) beside
   the least time the card could take, and the kernel again with every
   row at the table's last slot and with every row at position 0 (its
   fixed cost); then the same checks for its int8 form, over pools
   quantized with ``quant.quantize_tensor`` (one scale per position and
   head), whose scratch block and masked tails are poisoned with q = 127,
   s = NaN;
4. flash kernel: the flash-attention forward held against its plain
   version at the trainer's shapes ((16, 1024, 32, 128) bf16, causal,
   q/k/v views of one qkv tensor) and against the reference attention,
   then at odd shapes (non-causal, d 64, f32, a ragged sequence), a
   second call bitwise equal to the first at each; timed
   beside its bound, its plain version and
   ``scaled_dot_product_attention`` (a yardstick, never on the path),
   with the backward the trainer runs through it timed too; the gradient
   wiring of the flash entry checked (its backward is the reference
   attention's autograd, so this checks plumbing, not the kernel);
5. engine: greedy continuous-batching serving of the dense burn-in LM at
   full width (vocab 32768, d_model 4096, 32 heads, d_ff 16384, 8
   layers, seq 1024; random weights from a seeded generator) through
   ``attn_backend="cuda"``: 16 requests through 8 slots, every kernel
   launch counted, then the same stream through the gather backend;
   then the same stream served int8 (``quant.quantize_params`` weights,
   ``kv_int8=True`` pool; three eager weight-dequantization routes checked
   bitwise and timed on one layer) through the int8 kernel, every launch counted,
   against the int8 gather engine, one int8 decode step's logits through
   both backends, and a profile of 8 int8 decode steps;
6. train: 6 momentum steps of the flash family at the same width (batch
   16, seq 1024; f32 masters, about 1.75 B parameters) through
   ``burnin.train``: the loss must descend, every flash launch counted;
   then MFU, peak memory, the first loss against the dense path's, the
   kernel's output inside the model's first layer against its plain
   version, and a profile of two steps;
7. the kernels' JSON line, the card's line, and the result line.

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; no network.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

# Paged kernel vs plain, both forms: both read the same bf16 values (an
# int8 element dequantized to bf16(f32(q) * s) on both sides) and round
# f32 sums taken in another order, so they may differ by about one bf16
# ulp of the value (at most 2**-7 of it).  Measured at the engine's
# shapes: 3.8e-6 (bf16) and 0.00048828125 (int8, 2**-11); 0.0 at the odd
# small shape.
PAGED_TOL = {"atol": 2 ** -9, "rtol": 2 ** -7}
# Flash kernel vs plain, bf16: both round one f32 result once, so they may
# differ by one bf16 ulp of the value (at most 2**-7 of it); measured
# 0.001953 (2**-9) at the trainer's shapes.
FLASH_BF16_TOL = {"atol": 2 ** -9, "rtol": 2 ** -7}
FLASH_F32_TOL = {"atol": 1e-5, "rtol": 1e-5}
FIRST_LOSS_RTOL = 1e-4  # flash vs dense first loss; measured 2.8e-6
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
# One decode step's rows at the engine's shapes: the first slot, mid-block,
# a block boundary, the table's last slot.
ENGINE_POS = [0, 63, 127, 128, 200, 383, 511, 639]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, n: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn`` in ms over ``n`` calls, each bracketed
    by CUDA events, with the L2 flushed before each.  A spin of about 5 ms
    on the device precedes each call, so that the host has enqueued all
    of ``fn``'s work before the start event runs: the events then time
    the device work, not the host's Python in between."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush()
        torch.cuda._sleep(10_000_000)  # clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_case(B, H, K, W, NW, NB, pos, seed):
    """A random pool and per-row tables: row b owns distinct real blocks
    for the columns its position reaches, scratch 0 beyond."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    k_pool = torch.randn((NB, W, H, K), generator=g, device="cuda").to(torch.bfloat16)
    v_pool = torch.randn((NB, W, H, K), generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randn((B, H, K), generator=g, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros((B, NW), dtype=torch.int32)
    used = 0
    for b, p in enumerate(pos):
        cols = p // W + 1
        table[b, :cols] = perm[used:used + cols]
        used += cols
    if used > NB - 1:
        raise ValueError("case needs more blocks than the pool has")
    return q, k_pool, v_pool, table.cuda(), torch.tensor(pos, dtype=torch.int32, device="cuda")


def int8_case(case, quant):
    """A case with its pools as the int8 pairs the engine stores: one
    scale per (position, head), over d_head."""
    q, k_pool, v_pool, table, pos = case
    return (q, quant.quantize_tensor(k_pool, (3,)), quant.quantize_tensor(v_pool, (3,)),
            table, pos)


def poison_bf16(k_pool, v_pool, table, pos):
    """Copies of bf16 pools with scratch block 0 and every row's masked
    tail overwritten by finite values."""
    W = k_pool.shape[1]
    pk, pv = k_pool.clone(), v_pool.clone()
    pk[0], pv[0] = 99.0, -55.0
    for b, p in enumerate(pos.tolist()):
        blk = int(table[b, p // W])
        pk[blk, p % W + 1:], pv[blk, p % W + 1:] = 77.0, 33.0
    return pk, pv


def poison_int8(k_pool, v_pool, table, pos):
    """Copies of int8 pools with scratch block 0 and every row's masked
    tail set to q = 127, s = NaN: any read of them shows in the output."""
    W = k_pool["q"].shape[1]
    out = []
    for pool in (k_pool, v_pool):
        pool = {leaf: t.clone() for leaf, t in pool.items()}
        pool["q"][0], pool["s"][0] = 127, float("nan")
        for b, p in enumerate(pos.tolist()):
            blk = int(table[b, p // W])
            pool["q"][blk, p % W + 1:], pool["s"][blk, p % W + 1:] = 127, float("nan")
        out.append(pool)
    return out


def check_kernel(case, plain, kernel, label, poison=poison_bf16):
    """Kernel against the plain version within PAGED_TOL; a second call
    and the poisoned scratch block and masked tails must leave it bitwise
    equal."""
    import torch

    q, k_pool, v_pool, table, pos = case
    want = plain(q, k_pool, v_pool, table, pos).float()
    got = kernel(q, k_pool, v_pool, table, pos)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{label}: kernel output not finite")
    err = (got.float() - want).abs().max().item()
    if not torch.allclose(got.float(), want, **PAGED_TOL):
        raise AssertionError(f"{label}: kernel vs plain max abs err {err} (tol {PAGED_TOL})")
    if not torch.equal(kernel(q, k_pool, v_pool, table, pos), got):
        raise AssertionError(f"{label}: two calls differ")
    poisoned = kernel(q, *poison(k_pool, v_pool, table, pos), table, pos)
    torch.cuda.synchronize()
    if not torch.equal(poisoned, got):
        raise AssertionError(f"{label}: masked tail or scratch leaked into the output")
    log(f"kernel {label}: max_abs_err={err} vs plain (tol {PAGED_TOL}); a second call and a "
        "poisoned tail unchanged (bitwise)")
    return err


def kernel_bound_ms(case):
    """The least time for one call: each input byte read once (K and V
    of the visible positions only: 2 * K bytes a position and head in
    bf16, K + 4 in int8 with its f32 scale; q, the table, pos), the
    output written once, at the HBM rate; or the flops at the bf16 peak."""
    q, k_pool, v_pool, table, pos = case
    B, H, K = q.shape
    int8 = isinstance(k_pool, dict)
    W, NW = (k_pool["q"] if int8 else k_pool).shape[1], table.shape[1]
    visible = sum(min(p + 1, NW * W) for p in pos.tolist())
    kv_bytes = K + 4 if int8 else 2 * K
    nbytes = 2 * visible * H * kv_bytes + 2 * B * H * K * 2 + table.numel() * 4 + B * 4
    flops = 4 * visible * H * K
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / H100_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_kernels(torch, pa):
    big = make_case(8, 32, 128, 128, 5, 41, ENGINE_POS, seed=1)
    err = check_kernel(big, pa.paged_attention_plain, pa.paged_attention, "B8 H32 K128 W128 NW5")
    small = make_case(3, 4, 64, 4, 3, 10, [0, 5, 11], seed=2)
    check_kernel(small, pa.paged_attention_plain, pa.paged_attention, "B3 H4 K64 W4 NW3")

    scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = scrub.zero_
    kernel_ms = time_ms(lambda: pa.paged_attention(*big), flush)
    plain_ms = time_ms(lambda: pa.paged_attention_plain(*big), flush)
    bound_ms, bound_by = kernel_bound_ms(big)
    log(f"kernel timing at the engine's shapes: kernel {kernel_ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    # Every row at the table's last slot: 2.5x the bytes of the mixed case
    # above through the same longest row.
    full = make_case(8, 32, 128, 128, 5, 41, [639] * 8, seed=3)
    full_ms = time_ms(lambda: pa.paged_attention(*full), flush)
    log(f"kernel timing, all 8 rows at position 639: kernel {full_ms:.6f} ms, "
        f"bound {kernel_bound_ms(full)[0]:.6f} ms")
    # Every row at position 0: the same launch with next to no bytes, so
    # the kernel's fixed cost (launch, the pos -> table -> pool chain, the
    # cluster exchanges).
    empty = make_case(8, 32, 128, 128, 5, 41, [0] * 8, seed=4)
    empty_ms = time_ms(lambda: pa.paged_attention(*empty), flush)
    log(f"kernel timing, all 8 rows at position 0: kernel {empty_ms:.6f} ms")
    clusters, resident = pa.cluster_occupancy(8, 32, 128, 128, 5)
    log(f"kernel launch at the engine's shapes: {clusters} clusters of 8 blocks; the card holds "
        f"{resident} at once")
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "tpu_dra_torch/parallel/kernels/csrc/paged_attn.cu",
        "replaces": "tpu_dra/parallel/kernels/paged_attn.py:177",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # No single PyTorch call attends a query over a block table.
        "library_ms": None,
    }


def phase_kernels_int8(torch, pa, quant):
    """K1's int8 form at the engine's shapes and at one odd small shape,
    timed beside its bound and its plain version."""
    big = int8_case(make_case(8, 32, 128, 128, 5, 41, ENGINE_POS, seed=1), quant)
    err = check_kernel(big, pa.paged_attention_plain, pa.paged_attention,
                       "int8 B8 H32 K128 W128 NW5", poison_int8)
    small = int8_case(make_case(3, 4, 64, 4, 3, 10, [0, 5, 11], seed=2), quant)
    check_kernel(small, pa.paged_attention_plain, pa.paged_attention, "int8 B3 H4 K64 W4 NW3",
                 poison_int8)

    scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = scrub.zero_
    kernel_ms = time_ms(lambda: pa.paged_attention(*big), flush)
    plain_ms = time_ms(lambda: pa.paged_attention_plain(*big), flush)
    bound_ms, bound_by = kernel_bound_ms(big)
    log(f"int8 kernel timing at the engine's shapes: kernel {kernel_ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    return {
        "name": "paged_attention_int8",
        "route": "cuda",
        "source": "tpu_dra_torch/parallel/kernels/csrc/paged_attn.cu",
        "replaces": "tpu_dra/parallel/kernels/paged_attn.py:177",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def flash_qkv(b, s, h, d, dtype, seed):
    """q, k and v as strided views of one (b, s, 3, h, d) tensor, the
    layout the model's qkv product hands the kernel."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def flash_bound_ms(q, causal):
    """The least time for one call: q, k and v read once and the output
    written once at the HBM rate; or the products over the visible
    (query, key) pairs (2 flops per multiply-add, q.k and p.v) at the
    bf16 peak."""
    b, s, h, d = q.shape
    nbytes = 4 * q.numel() * q.element_size()
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / H100_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def check_flash(fa, shape, causal, dtype, block, seed, tol):
    """Kernel against the plain version at ``tol`` (allclose's atol and
    rtol), and a second call bitwise equal to the first; returns the max
    abs error and the inputs."""
    import torch

    q, k, v = flash_qkv(*shape, dtype, seed)
    want = fa.flash_attention_plain(q, k, v, causal, block, block).float()
    got = fa.flash_attention_forward(q, k, v, causal, block, block)
    torch.cuda.synchronize()
    label = f"flash b{shape[0]} s{shape[1]} h{shape[2]} d{shape[3]} {str(dtype)[6:]} causal={causal}"
    if got.shape != q.shape or got.dtype != dtype or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{label}: output {tuple(got.shape)} {got.dtype} or not finite")
    err = (got.float() - want).abs().max().item()
    if not torch.allclose(got.float(), want, **tol):
        raise AssertionError(f"{label}: kernel vs plain max abs err {err} (tol {tol})")
    if not torch.equal(fa.flash_attention_forward(q, k, v, causal, block, block), got):
        raise AssertionError(f"{label}: two calls differ")
    log(f"kernel {label}: max_abs_err={err} vs plain (tol {tol}); a second call equal (bitwise)")
    return err, (q, k, v)


def phase_flash(torch, fa, flash, ring):
    """K2 at the trainer's shapes, then at odd ones; timed beside its
    bound, its plain version and scaled_dot_product_attention."""
    shape = (16, 1024, 32, 128)
    err, (q, k, v) = check_flash(fa, shape, True, torch.bfloat16, 128, 11, FLASH_BF16_TOL)
    got = fa.flash_attention_forward(q, k, v, True, 128, 128).float()
    ref = ring.reference_attention(q, k, v, causal=True).float()
    ref_err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, atol=3e-2, rtol=0):
        raise AssertionError(f"flash vs reference_attention: max abs err {ref_err} > 3e-2")
    log(f"kernel flash at the trainer's shapes vs ring.reference_attention: max_abs_err={ref_err} (atol 3e-2)")
    del got, ref
    check_flash(fa, shape, False, torch.bfloat16, 128, 12, FLASH_BF16_TOL)
    check_flash(fa, (2, 192, 3, 64), True, torch.bfloat16, 64, 13, FLASH_BF16_TOL)
    check_flash(fa, (2, 192, 3, 64), False, torch.float32, 64, 14, FLASH_F32_TOL)
    check_flash(fa, (1, 200, 2, 128), True, torch.float32, 8, 15, FLASH_F32_TOL)

    scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = scrub.zero_
    kernel_ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, True, 128, 128), flush)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True, 128, 128), flush)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (b, h, s, d) views, no copy
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
    bound_ms, bound_by = flash_bound_ms(q, True)
    log(f"kernel timing at the trainer's shapes: flash kernel {kernel_ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, scaled_dot_product_attention {library_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    # The backward the trainer runs once a layer: the reference attention
    # recomputed over materialized (b, h, s, s) f32 scores, and its gradient.
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash.flash_attention(*qkv, True, 128, 128)
    g = torch.randn_like(out)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, qkv, g, retain_graph=True), flush,
                     n=10, warmup=2)
    log(f"flash backward (reference attention recomputed and differentiated) at the "
        f"trainer's shapes: {bwd_ms:.6f} ms")
    del qkv, out, g
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "tpu_dra_torch/parallel/kernels/csrc/flash_attn.cu",
        "replaces": "tpu_dra/parallel/flash.py:142",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def phase_flash_grads(torch, flash, ring):
    """The gradient through the flash entry against the reference
    attention's, within 1e-5.  The entry's backward is that oracle's
    autograd, so this checks the wiring (saved inputs, the arguments
    passed on, the views' gradients), not the kernel."""
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.randn((2, 512, 8, 128), generator=torch.Generator(device="cuda").manual_seed(21),
                        device="cuda").to(dtype)
        grads = []
        for fn in (flash.flash_attention, ring.reference_attention):
            qkv = [t.detach().requires_grad_() for t in flash_qkv(2, 512, 8, 128, dtype, 22)]
            grads.append(torch.autograd.grad(fn(*qkv), qkv, g))
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(*grads))
        if err > 1e-5:
            raise AssertionError(f"flash gradients vs reference_attention ({dtype}): max abs err {err}")
        log(f"flash gradient wiring (2, 512, 8, 128) {str(dtype)[6:]}: max abs err {err} "
            "vs reference_attention")


def make_stream(vocab: int):
    import numpy as np

    rng = np.random.RandomState(0)
    stream = []
    for _ in range(16):
        length = int(rng.randint(64, 513))
        stream.append(([int(t) for t in rng.randint(0, vocab, length)], int(rng.randint(16, 65))))
    return stream


def serve(ServeEngine, params, cfg, stream, backend, kv_int8=False):
    """Drive the stream through one engine tick by tick.  Returns the
    engine, the finished requests by id, the run's wall seconds and the
    wall times of ticks that admitted nothing (one decode step each)."""
    import torch

    eng = ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                      attn_backend=backend, kv_int8=kv_int8)
    ids = [eng.submit(p, b) for p, b in stream]
    step_walls = []
    done = {}
    t0 = time.perf_counter()
    while not eng.idle:
        queued = eng.queued
        t = time.perf_counter()
        done.update((r.id, r) for r in eng.tick())
        if eng.queued == queued:
            step_walls.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(done) != sorted(ids):
        raise AssertionError(f"{backend}: finished {sorted(done)} of {sorted(ids)}")
    return eng, done, wall, step_walls


def profile_decode(torch, ServeEngine, params, cfg, steps: int = 8, kv_int8=False):
    """Where a decode step's device time goes: 8 rows mid-decode (contexts
    256..480 tokens), ``steps`` steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                      attn_backend="cuda", kv_int8=kv_int8)
    for i in range(8):
        eng.submit([(7 * i + j) % cfg.vocab for j in range(256 + 32 * i)], 64)
    eng.tick()  # admits all eight, then one step
    eng.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.tick()
        torch.cuda.synchronize()
    eng.close()
    form = "int8" if kv_int8 else "bf16"
    report_profile(prof, f"chip_smoke_decode_{form}_trace.json",
                   f"{steps} {form} decode steps of 8 rows", steps,
                   INT8_DECODE_KINDS if kv_int8 else KERNEL_KINDS)


KERNEL_KINDS = (  # (substring of a kernel's name, kind), first match wins
    ("paged_attention_kernel", "paged attention (K1)"),
    ("flash_fwd_kernel", "flash attention (K2)"),
    ("nvjet", "cuBLAS GEMM"),
    ("gemm", "cuBLAS GEMM"),
    ("reduce_kernel", "reduction"),
    ("softmax", "reduction"),
    ("copy", "copy / cast"),
    ("index", "index / gather / scatter"),
    ("elementwise", "elementwise"),
)
# In an int8 decode step the one product with a cast (int8 and f32 in,
# bf16 out) is quant.dequantize_bf16, 4 a layer and 1 for the logits; the
# training step has products of that name too, so the kind is the int8
# decode profile's alone.
INT8_DECODE_KINDS = (
    ("gpu_kernel_impl<at::native::BinaryFunctor<float, float, float, "
     "at::native::binary_internal::MulFunctor", "int8 dequantization"),
    *KERNEL_KINDS,
)


def report_profile(prof, trace_name, label, steps, kinds=KERNEL_KINDS):
    """Kernel time by name and by kind from the profile's exported trace
    (written to chiprun_out/), and the device's idle share: one minus the
    time some kernel runs (the union of the kernels' intervals) over the
    span from the first kernel's start to the last one's end, all on the
    device's clock in the one profiled run.  The profiler slows the
    host's dispatch, so a host-bound run idles somewhat more here than
    unprofiled."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, trace_name)
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    if not kernels:
        log(f"profile, {label}: the trace holds no device kernels; device time not measured")
        return
    by_name: "dict[str, float]" = {}
    by_kind: "dict[str, float]" = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        kind = next((k for s, k in kinds if s in e["name"]), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + float(e["dur"])
    busy_ms = sum(by_name.values()) / 1e3
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    covered, reach = 0.0, spans[0][0]
    for start, end in spans:
        covered += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    span_ms = (reach - spans[0][0]) / 1e3
    idle = 1 - covered / 1e3 / span_ms if span_ms > 0 else 0.0
    log(f"profile, {label}: kernel time {busy_ms:.3f} ms, kernels span {span_ms:.3f} ms "
        f"on the device, device idle share {idle:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / steps / 1e3:.4f} ms/step  {us / 1e3 / busy_ms:.4f} of kernel time  {name[:100]}")
    log("  by kind: " + "; ".join(
        f"{kind} {us / steps / 1e3:.4f} ms/step ({us / 1e3 / busy_ms:.4f})"
        for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1])))


# The serving width: `tpu_dra/parallel/mfu.py`'s rung for an 80 GB card.
SERVE_WIDTH = dict(vocab=32768, d_model=4096, n_heads=32, d_ff=16384, n_layers=8, seq=1024,
                   batch=16)


def serve_main_path(ServeEngine, pa, quant, params, cfg, stream, form, kv_int8=False):
    """The stream through the kernel backend after a warm-up, the
    kernel's launches counted from 0 just before and read just after;
    every request finished on its budget, every block freed, one launch
    a layer a step.  Returns the finished requests by id, the launches
    and the pool's bytes."""
    # Warm-up (cuBLAS handles, the caching allocator) off the record.
    serve(ServeEngine, params, cfg, stream[:2], "cuda", kv_int8)[0].close()

    pa.paged_attention.launches = 0  # count only the main path's launches
    eng, done, wall, steps = serve(ServeEngine, params, cfg, stream, "cuda", kv_int8)
    launches = pa.paged_attention.launches
    nb = eng.kv_stats()["blocks_total"]
    if (eng.block_size, nb) != (128, 41):
        raise AssertionError(f"expected W=128 and 41 blocks, got {eng.block_size}, {nb}")
    for r in done.values():
        if r.finish_reason != "budget" or len(r.tokens) != r.max_new:
            raise AssertionError(f"request {r.id}: {r.finish_reason} after {len(r.tokens)}")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"request {r.id}: token out of range")
    if eng.kv_stats()["blocks_free"] != nb - 1:
        raise AssertionError(f"blocks not conserved: {eng.kv_stats()}")
    if launches != eng.device_steps * cfg.n_layers:
        raise AssertionError(
            f"kernel launches {launches} != device steps {eng.device_steps} x {cfg.n_layers} layers"
        )
    n_tok = sum(len(r.tokens) for r in done.values())
    ttft = statistics.median(r.ttft_s for r in done.values())
    step_ms = statistics.median(steps) * 1e3
    log(f"engine {form} cuda: {len(done)} requests, {n_tok} tokens, {eng.device_steps} steps, "
        f"{launches} kernel launches; {n_tok / wall:.3f} tokens/s, TTFT p50 "
        f"{ttft * 1e3:.3f} ms, step p50 {step_ms:.3f} ms (ticks without admission)")
    pool_bytes = quant.tree_bytes(eng._pool)
    eng.close()
    return done, launches, pool_bytes


def serve_gather(ServeEngine, params, cfg, stream, form, kv_int8=False):
    g_eng, g_done, g_wall, g_steps = serve(ServeEngine, params, cfg, stream, "gather", kv_int8)
    g_tok = sum(len(r.tokens) for r in g_done.values())
    log(f"engine {form} gather: {g_tok / g_wall:.3f} tokens/s, step p50 "
        f"{statistics.median(g_steps) * 1e3:.3f} ms")
    g_eng.close()
    return g_done


def check_near_ties(torch, done, g_done, logits_at, form):
    """Where greedy tokens first differ, the gather path must have been at
    a near-tie: its top-2 margin within 2 bf16 ulps of the row's largest
    logit (2**-6 relative), recomputed by ``logits_at(sequence)``."""
    diverged = 0
    for rid, r in done.items():
        a, b = r.tokens, g_done[rid].tokens
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        if i is None:
            continue
        diverged += 1
        with torch.no_grad():
            row = logits_at(r.prompt + a[:i])
        top2 = torch.topk(row, 2).values
        margin = (top2[0] - top2[1]).item()
        tol = 2 ** -6 * row.abs().max().item()
        log(f"request {rid}: tokens differ first at {i} ({a[i]} vs {b[i]}); "
            f"gather-path margin {margin} (near-tie tolerance {tol})")
        if margin > tol:
            raise AssertionError(f"request {rid}: tokens differ at {i} with margin {margin} > {tol}")
    log(f"engine {form} cuda vs gather: {len(done) - diverged} of {len(done)} requests "
        f"token-identical, {diverged} first differ at a near-tie")


def check_step_logits(torch, paged, params, cfg, pool, form):
    """One decode step's logits through both backends, on the same state."""
    table = torch.arange(1, 41, dtype=torch.int32, device="cuda").view(8, 5)
    pos = torch.tensor(ENGINE_POS, dtype=torch.int32, device="cuda")
    tok = torch.arange(8, dtype=torch.int32, device="cuda") * 1000
    out = {}
    for backend in ("gather", "cuda"):
        with torch.no_grad():
            out[backend], _ = paged.paged_decode_step_rows(
                params, tok, pool, table, pos, cfg, backend=backend
            )
    ref, got = out["gather"], out["cuda"]
    if got.shape != (8, cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"{form} step logits: shape {tuple(got.shape)} or not finite")
    step_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not torch.allclose(got, ref, rtol=2 ** -6, atol=2 ** -6 * scale):
        raise AssertionError(f"{form} step logits cuda vs gather: max abs err {step_err} (scale {scale})")
    log(f"{form} decode step logits cuda vs gather: max abs err {step_err} of max |logit| {scale}")


def phase_engine(torch, cfg_mod, serve_mod, weights, quant, pa, paged):
    cfg = cfg_mod.BurninConfig(**SERVE_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = weights.cast_matrices(cfg_mod.init_params(cfg, gen, device="cuda"))
    stream = make_stream(cfg.vocab)

    done, launches, _ = serve_main_path(serve_mod.ServeEngine, pa, quant, params, cfg,
                                        stream, "bf16")
    g_done = serve_gather(serve_mod.ServeEngine, params, cfg, stream, "bf16")
    profile_decode(torch, serve_mod.ServeEngine, params, cfg)

    def dense_logits_at(seq):
        toks = torch.zeros((1, cfg.seq), dtype=torch.int32, device="cuda")
        toks[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        return cfg_mod.forward(params, toks, cfg)[0, len(seq) - 1]

    check_near_ties(torch, done, g_done, dense_logits_at, "bf16")

    pool = paged.init_block_pool(cfg, 41, 128, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for leaf in pool.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda") * 0.5)
    check_step_logits(torch, paged, params, cfg, pool, "bf16")
    return launches


def dequant_routes(torch):
    """Ways to turn an int8 leaf into ``bf16(f32(q) * s)``, all bitwise
    equal: one mixed-type product that rounds on its bf16 store; the f32
    product, then a cast; the f32 widening, then a product into bf16."""
    def into_bf16(a, s):
        return torch.mul(a, s, out=torch.empty(a.shape, dtype=torch.bfloat16, device=a.device))

    return {
        "one pass": lambda leaf: into_bf16(leaf["q"], leaf["s"]),
        "two step": lambda leaf: (leaf["q"].float() * leaf["s"]).to(torch.bfloat16),
        "widen, then product into bf16": lambda leaf: into_bf16(leaf["q"].float(), leaf["s"]),
    }


def check_dequant_routes(torch, quant, params, flush):
    """``quant.dequantize_bf16`` and every route of `dequant_routes` give
    the two-step product's bf16 bits on every int8 leaf on this card; then
    each is timed over one layer's four matrices (layer 0)."""
    routes = dequant_routes(torch)
    for name, leaf in [("embed", params["embed"]), *params["layers"].items()]:
        if quant.is_quantized_leaf(leaf):
            want = routes["two step"](leaf)
            for route, fn in [("dequantize_bf16", quant.dequantize_bf16), *routes.items()]:
                if not torch.equal(fn(leaf), want):
                    raise AssertionError(f"{route}({name}) differs from bf16(f32(q) * s)")
            del want
    log(f"dequantize_bf16 and the routes {sorted(routes)} equal bf16(f32(q) * s) bitwise on "
        "every int8 leaf")
    layer0 = [{"q": leaf["q"][0], "s": leaf["s"][0]} for leaf in params["layers"].values()
              if quant.is_quantized_leaf(leaf)]
    times = {
        route: time_ms(lambda fn=fn: [fn(leaf) for leaf in layer0], flush, n=50, warmup=5)
        for route, fn in [("dequantize_bf16", quant.dequantize_bf16), *routes.items()]
    }
    log(f"dequantization of layer 0's {len(layer0)} int8 matrices "
        f"({sum(leaf['q'].numel() for leaf in layer0)} values): "
        + "; ".join(f"{route} {ms:.6f} ms" for route, ms in times.items()))


def phase_engine_int8(torch, cfg_mod, serve_mod, weights, quant, pa, paged):
    """The same stream served int8: the same seeded params quantized on
    the card (`quant.quantize_params`), an int8 pool (``kv_int8=True``),
    the int8 kernel.  Returns its launches on that main path."""
    cfg = cfg_mod.BurninConfig(**SERVE_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = cfg_mod.init_params(cfg, gen, device="cuda")
    bf16_weight_bytes = quant.tree_bytes(weights.cast_matrices(full))
    params = quant.quantize_params(full)
    del full
    torch.cuda.empty_cache()
    stream = make_stream(cfg.vocab)

    check_dequant_routes(torch, quant, params, flush=torch.empty(
        64 * 2**20, dtype=torch.uint8, device="cuda").zero_)

    done, launches, pool_bytes = serve_main_path(serve_mod.ServeEngine, pa, quant, params,
                                                 cfg, stream, "int8", kv_int8=True)
    bf16_pool_bytes = quant.tree_bytes(paged.init_block_pool(cfg, 41, 128, device="cuda"))
    log(f"int8 engine bytes on the card: weights {quant.tree_bytes(params)} (bf16 engine "
        f"{bf16_weight_bytes}), pool {pool_bytes} (bf16 pool {bf16_pool_bytes})")
    g_done = serve_gather(serve_mod.ServeEngine, params, cfg, stream, "int8", kv_int8=True)

    # The near-tie margin recomputed through the int8 paged prefill of the
    # sequence so far: each window quantized at insert and read back, as
    # the engine's own prefill and decode do.
    slots = 640  # five 128-position windows: a 512-token prompt and its 63 tokens
    prefill = paged.make_paged_prefill(cfg, slots, 128)

    def int8_logits_at(seq):
        pool = paged.init_block_pool(cfg, 6, 128, kv_int8=True, device="cuda")
        toks = torch.zeros((1, slots), dtype=torch.int32, device="cuda")
        toks[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        table = torch.arange(1, 6, dtype=torch.int32, device="cuda")[None]
        lens = torch.tensor([len(seq)], dtype=torch.int32, device="cuda")
        return prefill(params, toks, lens, pool, table)[0][0]

    check_near_ties(torch, done, g_done, int8_logits_at, "int8")

    pool = paged.init_block_pool(cfg, 41, 128, kv_int8=True, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for leaf in pool.values():
        row = quant.quantize_tensor(torch.randn(leaf["q"].shape, generator=g, device="cuda") * 0.5,
                                    (4,))
        leaf["q"].copy_(row["q"])
        leaf["s"].copy_(row["s"])
    check_step_logits(torch, paged, params, cfg, pool, "int8")
    del pool
    profile_decode(torch, serve_mod.ServeEngine, params, cfg, kv_int8=True)
    return launches


def phase_train(torch, burnin, mfu, fa, flash, steps: int = 6):
    """Single-device training of the flash family at full width: the
    width `chip_sized_config` gives an 80 GB card, params from init_params'
    seeded generator, momentum at the config's lr.  Returns the kernel's
    launches in the ``train`` run."""
    cfg = dataclasses.replace(mfu.chip_sized_config(80), flash_attention=True)
    log(f"train config: vocab {cfg.vocab}, d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff "
        f"{cfg.d_ff}, {cfg.n_layers} layers, seq {cfg.seq}, batch {cfg.batch}, "
        f"{mfu.param_count(cfg)} params, {cfg.optimizer} lr {cfg.learning_rate}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_forward.launches = 0  # count only the main path's launches
    report = burnin.train(cfg, steps=steps, device="cuda")
    launches = fa.flash_attention_forward.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not report.ok or report.error:
        raise AssertionError(f"train: {report}")
    if not (math.isfinite(report.loss_first) and math.isfinite(report.loss_last)):
        raise AssertionError(f"train: loss not finite: {report}")
    # One launch per layer in the forward, one in the checkpoint's recompute.
    if launches != steps * 2 * cfg.n_layers:
        raise AssertionError(
            f"flash launches {launches} != {steps} steps x 2 x {cfg.n_layers} layers"
        )
    log(f"train flash: {report.steps} steps, loss {report.loss_first:.6f} -> {report.loss_last:.6f}, "
        f"step p50 {report.step_seconds_p50 * 1e3:.3f} ms, {report.tokens_per_second:.3f} tokens/s, "
        f"{launches} flash launches (2 a layer a step), peak memory allocated {peak_gb:.3f} GB")

    rep = mfu.measure_mfu(cfg, peak_tflops=H100_BF16_FLOPS / 1e12)
    if not rep.ok or rep.error:
        raise AssertionError(f"measure_mfu: {rep}")
    log(f"mfu: step {rep.step_seconds * 1e3:.3f} ms (8 steps back to back, one fetch), "
        f"{rep.tokens_per_second:.3f} tokens/s, {rep.achieved_tflops:.3f} TFLOP/s of model flops "
        f"(attention counted at the full s x s, as the reference counts it; recompute not "
        f"counted) = MFU {rep.mfu:.4f} of the 989 TFLOP/s bf16 peak")

    # The first step's loss through the kernel and through dense attention,
    # on the same params and tokens (the dense path fits under the
    # per-block checkpoint at this width).  The flash run's first call
    # (layer 0's forward) is caught and held against the plain version on
    # the same q/k/v views: at random init the loss alone would hardly
    # see a wrong attention output.
    tokens = burnin.prepare_tokens(cfg, "cuda")
    first, caught = {}, []
    real = flash.flash_attention

    def catch_first(q, k, v, *args):
        out = real(q, k, v, *args)
        if not caught:
            caught.append(((q.detach(), k.detach(), v.detach()), args, out.detach().clone()))
        return out

    for flash_on in (True, False):
        step_fn, state = burnin.make_train_step(
            dataclasses.replace(cfg, flash_attention=flash_on), "cuda")
        flash.flash_attention = catch_first  # `_block` imports it at each call
        try:
            first[flash_on] = float(step_fn(state, tokens)[1])
        finally:
            flash.flash_attention = real
        if flash_on:
            (q, k, v), args, got = caught[0]
            want = fa.flash_attention_plain(q, k, v, *args).float()
            in_model_err = (got.float() - want).abs().max().item()
            if got.shape != q.shape or not torch.allclose(got.float(), want, **FLASH_BF16_TOL):
                raise AssertionError(f"flash in layer 0 vs plain: max abs err {in_model_err}")
            log(f"flash output in layer 0 of the first step {tuple(q.shape)} {args}: max abs err "
                f"{in_model_err} vs plain (tol {FLASH_BF16_TOL})")
            del q, k, v, got, want, caught[:]
        del step_fn, state
        torch.cuda.empty_cache()
    rel = abs(first[True] - first[False]) / abs(first[False])
    if rel > FIRST_LOSS_RTOL:
        raise AssertionError(f"first loss flash {first[True]} vs dense {first[False]}: rel {rel}")
    log(f"first-step loss: flash {first[True]:.6f}, dense {first[False]:.6f}, rel diff {rel:.3e} "
        f"(tol {FIRST_LOSS_RTOL})")

    profile_train(torch, burnin, cfg)
    return launches


def profile_train(torch, burnin, cfg, steps: int = 2):
    """Where a training step's device time goes: ``steps`` steps under
    torch.profiler after one warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    step_fn, state = burnin.make_train_step(cfg, "cuda")
    tokens = burnin.prepare_tokens(cfg, "cuda")
    state, loss = step_fn(state, tokens)
    float(loss)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, loss = step_fn(state, tokens)
        float(loss)
    report_profile(prof, "chip_smoke_train_trace.json", f"{steps} training steps", steps)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    started = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tpu_dra_torch.parallel import burnin, flash, mfu, paged, quant, ring, serve, weights
        from tpu_dra_torch.parallel.kernels import _build
        from tpu_dra_torch.parallel.kernels import flash_attn as fa
        from tpu_dra_torch.parallel.kernels import paged_attn as pa
    except ImportError as e:
        print(f"chip_smoke: the tpu_dra_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 1

    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        log(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
            "bf16 reduced-precision reduction off, TF32 off")

        t = time.perf_counter()
        built = _build.build_all()
        log(f"build: {built} in {time.perf_counter() - t:.3f} s")
        for name in built:
            for line in _build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

        t = time.perf_counter()
        paged_row = phase_kernels(torch, pa)
        log(f"phase kernels: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        int8_row = phase_kernels_int8(torch, pa, quant)
        log(f"phase int8 kernel: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        flash_row = phase_flash(torch, fa, flash, ring)
        phase_flash_grads(torch, flash, ring)
        log(f"phase flash kernel: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        paged_row["launches"] = phase_engine(torch, burnin, serve, weights, quant, pa, paged)
        log(f"phase engine: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        int8_row["launches"] = phase_engine_int8(torch, burnin, serve, weights, quant, pa, paged)
        log(f"phase int8 engine: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        flash_row["launches"] = phase_train(torch, burnin, mfu, fa, flash)
        log(f"phase train: {time.perf_counter() - t:.3f} s")
        log(f"all phases: {time.perf_counter() - started:.3f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [paged_row, flash_row, int8_row]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
