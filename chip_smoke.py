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
   fixed cost), and over aliased tables (every row's first 3 blocks the
   same, as the prefix cache leaves them); then the same checks for its
   int8 form, over pools quantized with ``quant.quantize_tensor`` (one
   scale per position and head), whose scratch block and masked tails
   are poisoned with q = 127, s = NaN;
4. flash kernel: the flash-attention forward held against its plain
   version at the trainer's shapes ((16, 1024, 32, 128) bf16, causal,
   q/k/v views of one qkv tensor) and against the reference attention,
   then at odd shapes (non-causal, d 64, f32, a ragged sequence, the
   families' preset d 16 and d 32 on the CUDA cores), a
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
   then the engine's telemetry on the same stream through the kernel:
   ``telemetry=False`` and ``telemetry=True`` alternately, twice each
   (tokens bitwise the first run's, the kernel's launches and the host
   syncs unchanged, the step p50 of each mode pooled), each telemetry
   run's step records against the run (admissions, finishes, tokens;
   the phases tiling at least 0.95 of every tick that did device work),
   busy + idle equal to the summed step wall, each request's four spans
   under one trace, ``kv_snapshot`` conserved after every tick, a
   ``MetricsServer`` answering ``/metrics`` and the five debug routes,
   and ``profile_steps(8)``, whose trace must hold 8 steps x 8 layers of
   the kernel; then the same stream served int8 (``quant.quantize_params`` weights,
   ``kv_int8=True`` pool; three eager weight-dequantization routes checked
   bitwise and timed on one layer) through the int8 kernel, every launch counted,
   against the int8 gather engine, one int8 decode step's logits through
   both backends, and a profile of 8 int8 decode steps; then the stream
   sampled through the int8 kernel, every launch counted;
6. sampling: Threefry (`prng`) on the card bitwise against the CPU's;
   the stream sampled (temperature 0.8, top-k 50, top-p 0.95, logprobs)
   three ways through the kernel: continuous at 8 slots, fused ticks of 4,
   continuous at 4 slots; each run's waves, steps, wasted steps, device
   calls, launches and host syncs the counts the CPU schedule test pins;
   tokens equal across runs except where their recorded logits differ
   within 2 bf16 ulps; the filter mask against the CPU's; logprobs against
   the picks' logits; the sampler's device time and a sampled decode
   profile;
7. speculative: 128-token prompts, 64 new tokens, a 2-layer draft of 4 at
   B=1 and B=4 against `make_generate` (greedy, up to near-ties), its
   rounds and wall time; sampled; a full-depth draft's acceptance;
8. KV hierarchy, at the same width through the kernel, each path's
   launches counted (one a layer a step): the prefix cache (16 requests
   sharing a 384-token prefix, ``prefix_cache_slots=8``; cache on against
   cache off and against gather, aliases and COW copies made, 384 tokens
   reused on every hit, refcounts equal owners); the swap tier (a bitwise
   block round trip through pinned host memory in both pool formats, then
   4 priority-5 requests preempting 4 priority-0 ones in a 21-block pool;
   every swapped block restored, tokens against a roomy engine's, the
   swap traffic in GB/s each way); the handoff (8 requests moved from a
   prefill engine to a decode engine, alias over one shared pool with no
   block copied, then dma through a staging host pool; tokens against a
   mono engine's, blocks conserved across both engines); the disaggregated
   server (the main stream through ``DisaggServer``'s prefill and decode
   tiers, alias over one shared 41-block pool, then dma through the default
   staging pool: K1 launched by the decode tier only, none by the prefill
   tier, no block copied under alias, blocks conserved every tick, host
   syncs as the contract gives them, one weight storage for both tiers,
   tokens against a mono engine's); warm restart (the shared-prefix stream
   through a cold engine, its index exported, a fresh engine warm-started
   from it: 384 tokens reused on every request from the first admission,
   tokens against the cold engine's, the digest claiming 384 tokens of
   every prompt); then the serve fleet (`tpu_dra_torch.fleet.ServeFleet`
   over paged kernel replicas of 8 slots and 3 prefix entries, all on one
   cast weight tree; the reference's ``serve_fleet`` stanza at this width:
   40 requests over 5 families of 384-token system prompts, a cold pass
   and two steady ones, interleaved across fleets of 1, 2 and 4 replicas
   on the affinity router, 4 on the seeded random one and 4 ticked in one
   thread; every token against one engine's up to near-ties, K1's launches
   == device steps x layers pass by pass, each replica's host syncs its
   own contract's, ``/debug/fleet`` answering each fleet's `fleet_stats()`;
   tokens/s and TTFT p50 of the steady passes, prefill tokens reused and
   computed, placements by reason, weight and pool bytes);
9. rows and MoE: the MoE family (4 experts, capacity factor 1.25, about
   5 B parameters) served at the same width on the rows layout: the main
   stream greedy (waves, steps, wasted steps, calls and host syncs the
   counts the CPU schedule test pins; tokens against each request's B=1
   generation up to near-ties; tokens/s, TTFT, step time, weight and
   row-cache bytes; a decode profile split into router, dispatch/combine,
   expert GEMMs, attention and the rest), the same int8 (int8 experts,
   the router f32, an int8 row cache), sampled (continuous and fused
   ticks of 4; tokens across the two runs up to their logits' near-ties,
   logprobs against the picks' logits); the dense model on rows against
   the paged kernel engine; the rows prefix cache (384 tokens reused on
   every hit, tokens against the cache off) and a warm restart from its
   index (384 reused from the first admission); K1 held at 0 launches on
   every rows path; then the MoE family trained at the same width cut to
   2 layers (3 steps, loss descending, the load-balance term) and
   `serve_family` for every single-device family (moe also int8), the
   context-parallel and pipelined ones reporting their refusal;
   then sharded serving: a spawned worker on a one-rank NCCL mesh
   (`burnin_mesh([0])`) serves the main stream at full width through
   ``ServeEngine(mesh=)`` on the paged layout, bf16 and int8 (weights cut
   by ``weights.shard_params``, ``kv_int8``), its tokens bitwise phase
   5's gather engines'; ``DisaggServer`` with both tiers on the mesh,
   alias and dma, its tokens and both tiers' step records bitwise the
   one-device gather ``DisaggServer``'s in the same worker (blocks
   conserved every tick, host syncs as the contract gives them); the
   rows engine, ``make_generate_padded`` and
   rope ``make_generate`` on the mesh bitwise their one-device runs;
   `serve_family` for dense, flash and moe over the mesh (long_context
   refused); K1 and K2 at 0 launches on every mesh path; tokens/s, TTFT,
   step time and the weight and pool bytes a rank beside the one-device
   gather engine's in the same worker;
10. train: 6 momentum steps of the flash family at the same width (batch
   16, seq 1024; f32 masters, about 1.75 B parameters) through
   ``burnin.train``: the loss must descend, every flash launch counted;
   then MFU, peak memory, the first loss against the dense path's, the
   kernel's output inside the model's first layer against its plain
   version, and a profile of two steps;
11. sharded training: K2 through `flash_attention_sharded` rank by rank
   at the trainer's shape (tp 2, 4 and 8: one launch a rank on its heads,
   made contiguous as its column-parallel product makes them; the ranks'
   outputs concatenated bitwise equal to one launch over every head and
   within one bf16 ulp of the plain version; one rank's launch at tp 2
   timed beside its bound, its plain version and
   `scaled_dot_product_attention` on the same heads); then a spawned
   worker on a one-rank NCCL group trains the flash family at the same
   width through ``burnin.train(cfg, burnin_mesh([0]), steps=6)`` (K2's
   launches == steps x 2 x layers, the six losses bitwise or within
   ``FIRST_LOSS_RTOL`` of phase 10's, step p50 beside phase 10's) and the
   long-context (ring) and MoE families over that mesh for 2 steps (loss
   descending, no K1 launch);
12. long-context training: K2 on Ulysses' head-swapped views at the
   trainer's shape (P 2, 4 and 8: each rank's (b, s, 3, h / P, d) view laid
   out by the all-to-all's own packing, one launch a rank on its strided
   q/k/v views within one bf16 ulp of the plain version, the ranks' heads
   concatenated bitwise one launch over every head; one rank at P 2 timed
   beside its bound, its plain version and `scaled_dot_product_attention`);
   then a spawned worker on a one-rank NCCL group trains the
   long_context_a2a family (Ulysses + flash) at the trainer's width
   through ``burnin.train(cfg, burnin_mesh([0]), steps=6)`` (K2's launches
   == steps x 2 x layers, the losses bitwise or within
   ``FIRST_LOSS_RTOL`` of phase 10's, step p50 and peak memory beside
   phase 10's) and the long_context_moe family (ring + group-local
   experts) at the serving width cut to 2 layers on ``moe_mesh([0],
   model=1, expert=1)`` for 3 steps (loss descending, 0 K1 and 0 K2
   launches); the activation bound needs 4 ranks and is said not to run;
13. burn-in, the payload a claiming pod runs: the card's entry in
   `mfu.CHIP_PERF` and the saxpy probe of its memory rate (at most 1.05
   of the peak); `data.synthetic_stream` against the same draws on the
   card, `prefetch_to_device` (a side stream, an event wait a batch, every
   batch equal to its host source) and `train_on_stream` at the trainer's
   width for 6 steps (K2's launches == steps x 2 x layers, step p50 beside
   `burnin.train`'s); checkpoints of that width cut to 2 layers in a
   temporary directory (a bitwise round trip with save and restore GB/s;
   4 steps against 2, a restart and 2 more, the losses bitwise or within
   two uninterrupted runs' spread; the fall-back past a step torn under
   its marker, a ``.tmp`` orphan ignored; all of it deleted); then
   ``python -m tpu_dra_torch.parallel.validate`` as subprocesses (``--train
   2`` ok on one card with no checks and a descending loss; a claim of 2
   refused with exit 1; ``--family flash --train 2`` and ``--family dense
   --serve`` ok) and a one-rank NCCL group in a spawned worker running the
   collective checks;
14. training on the mesh, completed, in a spawned one-rank NCCL worker:
    the pipelined trainer (dense, the trainer's width, `pipeline_mesh([0],
    stages=1)`, 4 microbatches, 6 steps; losses within ``PIPE_LOSS_RTOL``
    of the one-device trainer's on the same weights and batch, step p50
    and peak memory beside its, 0 K1 and 0 K2 launches) and the pipelined
    family (2 experts, cut to 4 layers, 3 steps); `data.train_on_stream`
    of the flash family on `burnin_mesh([0])` (the rank's prefetched
    batches its slices of the host's, losses bitwise the one-device
    stream-fed trainer's, 96 K2 launches); checkpoints at 2 layers on the
    mesh (a bitwise round trip with save and restore GB/s, a run
    interrupted on the mesh and resumed on one device and the reverse,
    both bitwise the uninterrupted run's, the fall-back past a torn shard
    beside a ``.tmp`` orphan); then ``validate --family pipelined --train
    2`` (one card: the reference's `pipeline_mesh` refusal, exit 1);
15. Moonlight-16B-A3B at its published widths: K3 (the paged latent
    attention decode kernel) against its plain version at the engine's
    shapes (128 rows, contexts to 2,816), timed beside its bound; then
    the whole model through the paged engine, a few requests served
    through K3 (27 launches a decode step) with every prefill window
    and every decode step, the first included, replayed from the graphs
    the engine captured when it was built, a decode tick at 128 rows
    timed, and the
    served tokens against the plain reference (`tests/ref_mla_moe.py`);
16. the kernels' JSON line (K1's rows also list each path's launches, K2's
    the trainer's, the sharded trainer's, the Ulysses trainer's, the
    stream-fed and the checkpointed paths', the pipelined and the mesh
    payload's, and its times on the swapped view; K2's sharded form a row
    of its own; K3's row), the card's line, and the result line.

``python3 chip_smoke.py --cards N`` (N a multiple of 4, N cards) runs the
flash and long_context_a2a families sharded over N ranks against one
card, the activation bound (`moe.routing_temp_comparison`, ``local * 1.4
< global``) and ``validate`` over the N cards; then serves the main
stream at full width over N ranks (bf16 and int8, and through
``DisaggServer`` with both tiers on the mesh, alias and dma; every rank's
tokens and step records the same, and one card's tokens up to near-ties;
each rank's numbers and bytes) and
runs ``validate --family dense --serve`` and ``--family moe --serve
--int8`` over the N cards; then the pipelined family (2 experts, 4
layers) on (data 1, pipe 2, model 2) of 4 cards against one card with
pipe 1 (losses within the cards' tolerance, each rank's step p50 and
peak memory beside the GPipe bubble), and elastic resume: a checkpoint
saved on `burnin_mesh` of 4 cards resumed on 2, the resumed losses within
``ELASTIC_RTOL`` of the uninterrupted run's; then the serve fleet of 4
replicas, one on each of the first 4 cards (drained in threads, and
ticked in one thread), against 4 replicas on card 0 on the same stream:
tokens the one-card fleet's up to near-ties, K1 launches, host syncs,
each replica's tensors on its own card, tokens/s side by side.

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; no network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import warnings

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
# The same shapes over aliased tables: every row's first 3 blocks are the
# same (a 384-token shared prefix), then each row's own; positions past
# the prefix, from the first private slot to the table's last.
ALIASED_POS = [384, 400, 447, 500, 511, 512, 600, 639]


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


def make_case(B, H, K, W, NW, NB, pos, seed, shared=0):
    """A random pool and per-row tables: row b owns distinct real blocks
    for the columns its position reaches, scratch 0 beyond; with
    ``shared``, every row's first ``shared`` columns name the same blocks
    (the prefix cache's aliased tables)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    k_pool = torch.randn((NB, W, H, K), generator=g, device="cuda").to(torch.bfloat16)
    v_pool = torch.randn((NB, W, H, K), generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randn((B, H, K), generator=g, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros((B, NW), dtype=torch.int32)
    used = shared
    for b, p in enumerate(pos):
        cols = p // W + 1
        if cols <= shared:
            raise ValueError("each row of an aliased case needs a private block")
        table[b, :shared] = perm[:shared]
        table[b, shared:cols] = perm[used:used + cols - shared]
        used += cols - shared
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
    of the visible positions only, a position that several rows' tables
    name counted once: 2 * K bytes a position and head in bf16, K + 4 in
    int8 with its f32 scale; q, the table, pos), the output written once,
    at the HBM rate; or the flops (every row's visible positions) at the
    bf16 peak."""
    q, k_pool, v_pool, table, pos = case
    B, H, K = q.shape
    int8 = isinstance(k_pool, dict)
    W, NW = (k_pool["q"] if int8 else k_pool).shape[1], table.shape[1]
    rows = table.tolist()
    stored = {(rows[b][j // W], j % W) for b, p in enumerate(pos.tolist())
              for j in range(min(p + 1, NW * W))}
    visible = sum(min(p + 1, NW * W) for p in pos.tolist())
    kv_bytes = K + 4 if int8 else 2 * K
    nbytes = 2 * len(stored) * H * kv_bytes + 2 * B * H * K * 2 + table.numel() * 4 + B * 4
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
    aliased = make_case(8, 32, 128, 128, 5, 41, ALIASED_POS, seed=5, shared=3)
    check_kernel(aliased, pa.paged_attention_plain, pa.paged_attention,
                 "B8 H32 K128 W128 NW5, 3 shared blocks")
    aliased_ms = time_ms(lambda: pa.paged_attention(*aliased), flush)
    log(f"kernel timing over aliased tables (3 shared blocks, positions 384-639): kernel "
        f"{aliased_ms:.6f} ms, bound {kernel_bound_ms(aliased)[0]:.6f} ms; engine-shape case "
        f"{kernel_ms:.6f} ms")
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
    aliased = int8_case(make_case(8, 32, 128, 128, 5, 41, ALIASED_POS, seed=5, shared=3), quant)
    check_kernel(aliased, pa.paged_attention_plain, pa.paged_attention,
                 "int8 B8 H32 K128 W128 NW5, 3 shared blocks", poison_int8)
    aliased_ms = time_ms(lambda: pa.paged_attention(*aliased), flush)
    log(f"int8 kernel timing over aliased tables: kernel {aliased_ms:.6f} ms, bound "
        f"{kernel_bound_ms(aliased)[0]:.6f} ms; engine-shape case {kernel_ms:.6f} ms")
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
    # The families' preset head width (d_model 128 over 8 heads), both forms.
    check_flash(fa, (2, 128, 8, 16), True, torch.bfloat16, 128, 16, FLASH_BF16_TOL)
    check_flash(fa, (1, 200, 4, 32), False, torch.float32, 8, 17, FLASH_F32_TOL)

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


@contextlib.contextmanager
def host_syncs(torch):
    """Counts the synchronizing CUDA calls made inside the block (a copy
    to pageable host memory, a stream or device synchronize): PyTorch's
    sync debug mode warns on each.  After the block, ``[0]`` holds the
    count and ``[1]`` the lines of Python that made them, with counts."""
    found = [0, {}]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchronizing" in str(w.message):
            where = f"{os.path.basename(w.filename)}:{w.lineno}"
            found[0] += 1
            found[1][where] = found[1].get(where, 0) + 1


def count_waves(engines):
    """Counts the admission waves of ``engines`` from here on: the
    `_admit` calls that admitted a request (each ends in one fetch).  The
    count is in ``[0]``."""
    waves = [0]
    for eng in engines:
        def admit(_real=eng._admit):
            admitted, hits = _real()
            waves[0] += admitted > 0
            return admitted, hits

        eng._admit = admit
    return waves


def device_calls(eng) -> int:
    """The engine's decode calls so far: one a step under continuous
    scheduling, one a fused tick of ``steps_per_tick`` steps."""
    return eng.device_steps // (eng.steps_per_tick if eng.scheduling == "tick" else 1)


def check_host_syncs(syncs, waves: int, engines, label: str, dma: int = 0) -> str:
    """The engine's host-sync contract: one blocking fetch a device call
    (a decode step, or a fused tick) and one an admission wave; a
    preemption and a dma handoff add one each; prefix hits and swap-ins
    add none.  ``syncs`` is what `host_syncs` found.  Returns the count as
    text."""
    count, where = syncs
    calls = sum(device_calls(e) for e in engines)
    preempted = sum(e.kv_block_stats.get("preemptions_total", 0) for e in engines)
    want = calls + waves + preempted + dma
    if count != want:
        raise AssertionError(f"{label}: {count} host syncs ({where}), the contract gives {want} = "
                             f"{calls} device calls + {waves} waves + {preempted} preemptions + "
                             f"{dma} dma handoffs")
    return (f"{count} host syncs = {calls} device calls + {waves} admission waves + {preempted} "
            f"preemptions + {dma} dma handoffs")


# The sampled phase's policy and its three runs of the main stream.
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95, with_logprobs=True)
SAMPLED_RUNS = {
    "continuous": dict(slots=8),
    "tick": dict(slots=8, scheduling="tick", steps_per_tick=4),
    "continuous 4 slots": dict(slots=4),
}


def serve(ServeEngine, params, cfg, stream, backend, kv_int8=False, warm_up=False,
          before=None, after_tick=None, **engine_kw):
    """Drive the stream through one engine tick by tick, holding it to
    the host-sync contract unless it is a ``warm_up`` run (the first
    serving run of a process makes one more sync, inside torch's own
    first-use setup).  ``before(engine)`` runs ahead of the submissions
    (a warm start), ``after_tick(engine)`` after every tick, outside the
    tick's timing.  Returns the engine, the finished requests by id, the
    run's wall seconds, the wall times of ticks that admitted nothing
    (one decode step each) and the host-sync count as text."""
    import torch

    eng = ServeEngine(params, cfg, **{"slots": 8, "prompt_slots": 512, "max_new_cap": 64,
                                      "attn_backend": backend, "kv_int8": kv_int8, **engine_kw})
    if before is not None:
        before(eng)
    ids = [eng.submit(p, b) for p, b in stream]
    waves = count_waves([eng])
    step_walls = []
    done = {}
    t0 = time.perf_counter()
    with host_syncs(torch) as syncs:
        while eng.pending:
            queued = eng.queue_depth
            t = time.perf_counter()
            done.update((r.id, r) for r in eng.tick())
            if eng.queue_depth == queued:
                step_walls.append(time.perf_counter() - t)
            if after_tick is not None:
                after_tick(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(done) != sorted(ids):
        raise AssertionError(f"{backend}: finished {sorted(done)} of {sorted(ids)}")
    synced = "" if warm_up else (f"{check_host_syncs(syncs, waves[0], [eng], f'{backend} engine')}"
                                 f"; {decode_paths([eng], f'{backend} engine')}")
    return eng, done, wall, step_walls, synced


def decode_paths(engines, label: str) -> str:
    """The engines' decode steps by path (`prefix_stats`): a paged engine
    on one card, of either model, replays every step, its first
    included, from the graphs it captured when it was built; a mesh or
    rows engine none.  Returns the graph path's share as text."""
    graph = steps = 0
    for eng in engines:
        s = eng.prefix_stats
        want = eng.device_steps if eng.kv_layout == "paged" and eng.mesh is None else 0
        if (s["decode_steps_graph"], s["decode_steps_eager"]) != (want, eng.device_steps - want):
            raise AssertionError(f"{label}, {eng.name}: decode steps {s['decode_steps_graph']} "
                                 f"graph and {s['decode_steps_eager']} eager of "
                                 f"{eng.device_steps}, want {want} replayed")
        graph, steps = graph + want, steps + eng.device_steps
    return f"decode steps replayed {graph} of {steps} ({100 * graph / max(steps, 1):.1f} %)"


def profile_decode(torch, ServeEngine, params, cfg, steps: int = 8, kv_int8=False,
                   backend: str = "cuda", form: "str | None" = None, report: bool = True,
                   **engine_kw):
    """Where a decode step's device time goes: 8 rows mid-decode (contexts
    256..480 tokens), ``steps`` steps under torch.profiler (on a mesh,
    ``mesh`` in ``engine_kw``, every rank steps and only a ``report`` one
    is profiled).  Returns the kernel time a step in ms."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                      attn_backend=backend, kv_int8=kv_int8, **engine_kw)
    for i in range(8):
        eng.submit([(7 * i + j) % cfg.vocab for j in range(256 + 32 * i)], 64)
    eng.tick()  # admits all eight, then one step
    eng.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if report \
            else contextlib.nullcontext() as prof:
        for _ in range(steps):
            eng.tick()
        torch.cuda.synchronize()
    eng.close()
    if not report:
        return None
    if form is None:
        form = ("int8" if kv_int8 else "bf16") + (" sampled" if engine_kw else "")
    return report_profile(prof, f"chip_smoke_decode_{form.replace(' ', '_')}_trace.json",
                          f"{steps} {form} decode steps of 8 rows", steps,
                          INT8_DECODE_KINDS if kv_int8 else KERNEL_KINDS)


KERNEL_KINDS = (  # (substring of a kernel's name, kind), first match wins
    ("AllGather", "NCCL all-gather"),
    ("AllReduce", "NCCL all-reduce"),
    ("ReduceScatter", "NCCL reduce-scatter"),
    ("paged_attention_kernel", "paged attention (K1)"),
    ("flash_fwd_kernel", "flash attention (K2)"),
    ("nvjet", "cuBLAS GEMM"),
    ("gemm", "cuBLAS GEMM"),
    ("Sort", "sort"),
    ("sort", "sort"),
    ("Scan", "scan"),
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
    unprofiled.  Returns the kernel time a step in ms (None when the
    trace holds no kernels)."""
    kernels = trace_kernels(prof, trace_name)
    if not kernels:
        log(f"profile, {label}: the trace holds no device kernels; device time not measured")
        return None
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
    log(f"profile, {label}: kernel time {busy_ms:.3f} ms in {len(kernels) / steps:.2f} kernels "
        f"a step, kernels span {span_ms:.3f} ms on the device, device idle share {idle:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / steps / 1e3:.4f} ms/step  {us / 1e3 / busy_ms:.4f} of kernel time  {name[:100]}")
    log("  by kind: " + "; ".join(
        f"{kind} {us / steps / 1e3:.4f} ms/step ({us / 1e3 / busy_ms:.4f})"
        for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    return busy_ms / steps


def trace_kernels(prof, trace_name):
    """The device kernels of a profile, from its chrome trace (written to
    chiprun_out/)."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, trace_name)
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]


# The serving width: `tpu_dra/parallel/mfu.py`'s rung for an 80 GB card.
SERVE_WIDTH = dict(vocab=32768, d_model=4096, n_heads=32, d_ff=16384, n_layers=8, seq=1024,
                   batch=16)
# The MoE family's experts at the serving width (the `moe` preset's 4).
MOE = dict(moe_experts=4, moe_capacity=1.25)
# The rows-and-MoE phase's runs of the main stream through the MoE rows
# engine, and their counts (admission waves, device steps, wasted steps,
# device calls), which tests/test_torch_rows.py's TestSmokeSchedule pins
# on the CPU: its requests finish on their budgets, so the counts do not
# depend on the width.  Host syncs are calls + waves.
ROWS_RUNS = {
    "moe greedy": dict(slots=8),
    "moe sampled": dict(slots=8, **SAMPLING),
    "moe sampled tick": dict(slots=8, scheduling="tick", steps_per_tick=4, **SAMPLING),
}
ROWS_SCHEDULE = {"moe greedy": (8, 113, 0, 113), "moe sampled": (8, 113, 0, 113),
                 "moe sampled tick": (8, 116, 29, 29)}


def serve_main_path(ServeEngine, pa, quant, params, cfg, stream, form, kv_int8=False):
    """The stream through the kernel backend after a warm-up, the
    kernel's launches counted from 0 just before and read just after;
    every request finished on its budget, every block freed, one launch
    a layer a step.  Returns the finished requests by id, the launches
    and the pool's bytes."""
    # Warm-up (cuBLAS handles, the caching allocator) off the record.
    serve(ServeEngine, params, cfg, stream[:2], "cuda", kv_int8, warm_up=True)[0].close()

    pa.paged_attention.launches = 0  # count only the main path's launches
    eng, done, wall, steps, synced = serve(ServeEngine, params, cfg, stream, "cuda", kv_int8)
    launches = pa.paged_attention.launches
    nb = eng.kv_block_stats["blocks_total"]
    if (eng.block_size, nb) != (128, 41):
        raise AssertionError(f"expected W=128 and 41 blocks, got {eng.block_size}, {nb}")
    for r in done.values():
        if r.finish_reason != "budget" or len(r.tokens) != r.max_new:
            raise AssertionError(f"request {r.id}: {r.finish_reason} after {len(r.tokens)}")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"request {r.id}: token out of range")
    if eng.kv_block_stats["blocks_free"] != nb - 1:
        raise AssertionError(f"blocks not conserved: {eng.kv_block_stats}")
    if launches != eng.device_steps * cfg.n_layers:
        raise AssertionError(
            f"kernel launches {launches} != device steps {eng.device_steps} x {cfg.n_layers} layers"
        )
    n_tok = sum(len(r.tokens) for r in done.values())
    ttft = statistics.median(r.ttft_s for r in done.values())
    step_ms = statistics.median(steps) * 1e3
    line = (f"{n_tok / wall:.3f} tokens/s, TTFT p50 {ttft * 1e3:.3f} ms, step p50 "
            f"{step_ms:.3f} ms (ticks without admission)")
    log(f"engine {form} cuda: {len(done)} requests, {n_tok} tokens, {eng.device_steps} steps, "
        f"{launches} kernel launches; {line}; {synced}")
    pool_bytes = quant.tree_bytes(eng._pool)
    eng.close()
    return done, launches, pool_bytes, line


def serve_sampled_int8(ServeEngine, pa, params, cfg, stream):
    """The stream sampled (`SAMPLING`) through the int8 kernel, int8
    weights and pool: K1's int8 form on the sampled path, its launches
    counted from 0, steps x layers, the continuous schedule's steps,
    every logprob finite and at most 0.  Returns the launches."""
    # The sampler's first use (its own kernels, the caching allocator)
    # off the record.
    serve(ServeEngine, params, cfg, stream[:2], "cuda", True, warm_up=True,
          **SAMPLING)[0].close()
    pa.paged_attention.launches = 0
    eng, done, wall, steps, synced = serve(ServeEngine, params, cfg, stream, "cuda", True,
                                           **SAMPLING)
    launches = pa.paged_attention.launches
    if (eng.device_steps, launches) != (SAMPLED_SCHEDULE["continuous"][1],
                                        eng.device_steps * cfg.n_layers):
        raise AssertionError(f"int8 sampled: {eng.device_steps} steps, {launches} launches")
    if not all(math.isfinite(lp) and lp <= 0 for r in done.values() for lp in r.logprobs):
        raise AssertionError("int8 sampled: a logprob is not finite or above 0")
    log(f"engine int8 sampled (T 0.8, top_k 50, top_p 0.95): {eng.device_steps} steps, "
        f"{launches} kernel launches; {serving_line(done, wall, steps)}; {synced}")
    eng.close()
    return launches


def serve_gather(ServeEngine, params, cfg, stream, form, kv_int8=False):
    g_eng, g_done, g_wall, g_steps, _ = serve(ServeEngine, params, cfg, stream, "gather", kv_int8)
    g_tok = sum(len(r.tokens) for r in g_done.values())
    log(f"engine {form} gather: {g_tok / g_wall:.3f} tokens/s, step p50 "
        f"{statistics.median(g_steps) * 1e3:.3f} ms")
    g_eng.close()
    return g_done


def check_near_ties(torch, done, g_done, logits_at, label):
    """Where greedy tokens first differ, the second run (``g_done``, by
    the same ids) must have been at a near-tie: its top-2 margin within 2
    bf16 ulps of the row's largest logit (2**-6 relative), recomputed by
    ``logits_at(sequence)``."""
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
            f"margin {margin} (near-tie tolerance {tol})")
        if margin > tol:
            raise AssertionError(
                f"{label}, request {rid}: tokens differ at {i} with margin {margin} > {tol}")
    log(f"engine {label}: {len(done) - diverged} of {len(done)} requests "
        f"token-identical, {diverged} first differ at a near-tie")


def dense_logits_at(cfg_mod, params, cfg):
    """``logits_at(sequence)``: the dense forward's logits at the last
    position of a sequence (zero-padded to the context)."""
    import torch

    def logits_at(seq):
        toks = torch.zeros((1, cfg.seq), dtype=torch.int32, device="cuda")
        toks[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        return cfg_mod.forward(params, toks, cfg)[0, len(seq) - 1]

    return logits_at


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

    done, launches, _, line = serve_main_path(serve_mod.ServeEngine, pa, quant, params, cfg,
                                              stream, "bf16")
    g_done = serve_gather(serve_mod.ServeEngine, params, cfg, stream, "bf16")
    profile_decode(torch, serve_mod.ServeEngine, params, cfg)

    check_near_ties(torch, done, g_done, dense_logits_at(cfg_mod, params, cfg),
                    "bf16 cuda vs gather")

    pool = paged.init_block_pool(cfg, 41, 128, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for leaf in pool.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda") * 0.5)
    check_step_logits(torch, paged, params, cfg, pool, "bf16")
    del pool
    telemetry = phase_telemetry(torch, serve_mod, pa, params, cfg, stream, done, launches)
    return launches, line, done, {rid: list(r.tokens) for rid, r in g_done.items()}, telemetry


SPAN_NAMES = ["serve.admit", "serve.decode", "serve.queue", "serve.request"]
PROFILE_STEPS = 8  # the device calls `profile_steps` captures
PHASE_CLOSURE = 0.95  # the phases' least share of a tick that did device work


def check_request_spans(trace, done, label: str) -> None:
    """Each finished request's spans: the four names, one trace id, the
    root a trace root and every other span's parent."""
    for rid, r in done.items():
        spans = trace.EXPORTER.spans(trace_id=r.trace_id)
        names = sorted(sp["name"] for sp in spans)
        root = [sp for sp in spans if sp["name"] == "serve.request"]
        if (names != SPAN_NAMES or len(root) != 1 or root[0]["parent_id"]
                or any(sp["trace_id"] != r.trace_id for sp in spans)
                or any(sp["parent_id"] != root[0]["span_id"] for sp in spans
                       if sp is not root[0])):
            raise AssertionError(f"{label}, request {rid}: spans {names}, "
                                 f"{[(sp['name'], sp['parent_id']) for sp in spans]}")


def check_kv_snapshot(eng, label: str) -> None:
    """The engine's ``/debug/kv`` snapshot against its block counts: one
    record per allocated block, each block's refcount its owner tags."""
    snap = eng.kv_snapshot()
    stats = eng.kv_block_stats
    blocks = snap["blocks"]
    if (len(blocks) != stats["blocks_allocated"]
            or any(b["refcount"] != len(b["owners"]) for b in blocks)
            or sum(snap["free_runs"]) != stats["blocks_free"]):
        raise AssertionError(f"{label}: kv_snapshot {snap} against {stats}")


def check_step_records(records, stream, label: str) -> str:
    """The run's `StepRecord`s against the run: every request admitted
    and finished once, the stream's tokens, and the phases tiling at
    least ``PHASE_CLOSURE`` of every tick that did device work.  Returns
    the smallest closure as text."""
    sums = {k: sum(getattr(r, k) for r in records) for k in ("admitted", "finished", "tokens")}
    want = {"admitted": len(stream), "finished": len(stream),
            "tokens": sum(b for _, b in stream)}
    if sums != want:
        raise AssertionError(f"{label}: step records sum to {sums}, the run to {want}")
    closure = min(sum(r.phase_s.values()) / r.step_wall_s for r in records
                  if r.occupancy or r.admitted)
    if closure < PHASE_CLOSURE:
        raise AssertionError(f"{label}: the phases tile {closure:.4f} of a tick")
    return f"{closure:.4f}"


def phase_telemetry(torch, serve_mod, pa, params, cfg, stream, kernel_done, kernel_launches):
    """The engine's telemetry at phase 5's width, stream and slots, through
    the kernel: the stream with ``telemetry=False`` and ``telemetry=True``,
    alternately, twice each (tokens bitwise phase 5's, K1's launches phase
    5's, host syncs as the contract gives them: the telemetry adds none;
    the step p50 of the two modes' runs pooled); the
    step records against the run (admissions, finishes, tokens; the
    phases tiling at least ``PHASE_CLOSURE`` of every tick that did device
    work); the capacity split (busy + idle == the summed step wall); each
    request's four spans under one trace id; the ``/debug/kv`` snapshot's
    blocks conserved after every tick; `profile_steps` over
    ``PROFILE_STEPS`` device calls (its trace holding steps x layers K1
    launches); a `MetricsServer` answering every route.  Returns the K1
    launches by path."""
    import urllib.request

    from tpu_dra_torch.utils import metrics, servestats, trace

    runs = {}
    for on, name in ((False, "telemetry-off"), (True, "telemetry-on"),
                     (False, "telemetry-off-2"), (True, "telemetry-on-2")):
        pa.paged_attention.launches = 0
        eng, done, wall, steps, synced = serve(
            serve_mod.ServeEngine, params, cfg, stream, "cuda", telemetry=on, name=name,
            after_tick=(lambda e: check_kv_snapshot(e, name)) if on else None)
        launches = pa.paged_attention.launches
        if launches != kernel_launches or launches != eng.device_steps * cfg.n_layers:
            raise AssertionError(f"{name}: {launches} K1 launches, phase 5 made {kernel_launches}")
        tokens = {rid: list(r.tokens) for rid, r in done.items()}
        if tokens != {rid: list(r.tokens) for rid, r in kernel_done.items()}:
            raise AssertionError(f"{name}: tokens differ from phase 5's")
        runs[name] = dict(eng=eng, done=done, steps=steps, launches=launches, synced=synced,
                          p50=statistics.median(steps), wall=wall, on=on)
        if on:
            records = servestats.RECORDER.query(engine=name)
            closure = check_step_records(records, stream, name)
            walls = sum(r.step_wall_s for r in records)
            cap = eng.capacity_snapshot()
            if (abs(cap["busy_s"] + cap["idle_s"] - walls) > 1e-9 * walls
                    or cap["steps"] != len(records)):
                raise AssertionError(f"{name}: capacity split {cap} against {len(records)} "
                                     f"ticks, {walls} s")
            check_request_spans(trace, done, name)
            shares = {p: v["fraction"]
                      for p, v in servestats.summarize(records)["phases"].items()}
            log(f"{name}: {len(records)} step records summing to the run, the phases tiling at "
                f"least {closure} of a tick, a tick's phase shares {shares}; busy "
                f"{cap['busy_s']:.6f} s + idle {cap['idle_s']:.6f} s = the summed step wall "
                f"{walls:.6f} s; each request's four spans under one trace; kv_snapshot "
                f"conserved every tick")
        elif servestats.RECORDER.query(engine=name):
            raise AssertionError(f"{name}: step records were made")
        tps = sum(len(r.tokens) for r in done.values()) / wall
        log(f"{name}: tokens bitwise phase 5's, {launches} K1 launches; {synced}; step p50 "
            f"{runs[name]['p50'] * 1e3:.3f} ms, {tps:.3f} tokens/s (host clocks)")
    pooled = {on: statistics.median([w for r in runs.values() if r["on"] == on
                                     for w in r["steps"]]) for on in (False, True)}
    log(f"telemetry step p50, both runs of each mode pooled (ticks without admission, host "
        f"clock): off {pooled[False] * 1e3:.3f} ms, on {pooled[True] * 1e3:.3f} ms, on/off "
        f"{pooled[True] / pooled[False]:.4f}")
    on = runs["telemetry-on"]
    records = servestats.RECORDER.query(engine="telemetry-on")

    # The six routes, while the telemetry-on engine is still registered.
    srv = metrics.MetricsServer("127.0.0.1:0")
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        answered = {}
        for route in ("/metrics", "/debug/engine?engine=telemetry-on", "/debug/kv",
                      "/debug/requests?engine=telemetry-on", "/debug/capacity",
                      f"/debug/traces?trace_id={on['done'][0].trace_id}"):
            with urllib.request.urlopen(base + route, timeout=30) as resp:
                body = resp.read().decode()
                answered[route.split("?")[0]] = (resp.status, len(body))
            if route.startswith("/debug/engine") and len(json.loads(body)["steps"]) != len(
                    records):
                raise AssertionError(f"{route}: {body[:300]}")
            if route == "/debug/kv" and not any(e["engine"] == "telemetry-on"
                                                for e in json.loads(body)["engines"]):
                raise AssertionError(f"{route}: {body[:300]}")
            if route == "/metrics" and 'tpu_dra_serve_tier_engines{engine="telemetry-on"' not in body:
                raise AssertionError(f"{route}: no telemetry-on series")
        with urllib.request.urlopen(base + "/debug/engine?engine=telemetry-on&format=text",
                                    timeout=30) as resp:
            text = resp.read().decode()
    finally:
        srv.stop()
    if any(status != 200 for status, _ in answered.values()):
        raise AssertionError(f"MetricsServer: {answered}")
    log(f"MetricsServer on 127.0.0.1: (status, bytes) {answered}; /debug/engine as text: "
        f"{text.splitlines()[0]} | {text.splitlines()[1]}")
    for run in runs.values():
        run["eng"].close()
    del runs

    # The deep profiler over the first PROFILE_STEPS decode calls.
    root = os.path.dirname(os.path.abspath(__file__))
    eng = serve_mod.ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                                attn_backend="cuda", name="telemetry-profile")
    eng.profile_steps(PROFILE_STEPS, os.path.join(root, "chiprun_out", "telemetry_profile"))
    pa.paged_attention.launches = 0
    for p, b in stream:
        eng.submit(p, b)
    eng.run()
    launches = pa.paged_attention.launches
    if eng.profiling or eng.profile_error:
        raise AssertionError(f"profile_steps: armed {eng.profiling}, error {eng.profile_error}")
    with open(eng.profile_path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel" and "paged_attention_kernel" in e["name"]]
    if len(k1) != PROFILE_STEPS * cfg.n_layers or launches != eng.device_steps * cfg.n_layers:
        raise AssertionError(f"profile_steps: {len(k1)} K1 launches in the trace (want "
                             f"{PROFILE_STEPS * cfg.n_layers}); {launches} in the run")
    k1_us = statistics.median(e["dur"] for e in k1)
    log(f"profile_steps({PROFILE_STEPS}): {len(k1)} K1 launches in "
        f"{os.path.relpath(eng.profile_path, root)} (median {k1_us:.3f} us on the device), "
        f"disarmed; the run's {launches} launches")
    eng.close()
    return {"engine telemetry off": kernel_launches, "engine telemetry on": kernel_launches,
            "engine profile_steps": launches, "profile_steps trace": len(k1)}


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

    done, launches, pool_bytes, _ = serve_main_path(serve_mod.ServeEngine, pa, quant, params,
                                                    cfg, stream, "int8", kv_int8=True)
    sampled = serve_sampled_int8(serve_mod.ServeEngine, pa, params, cfg, stream)
    bf16_pool_bytes = quant.tree_bytes(paged.init_block_pool(cfg, 41, 128, device="cuda"))
    log(f"int8 engine bytes on the card: weights {quant.tree_bytes(params)} (bf16 engine "
        f"{bf16_weight_bytes}), pool {pool_bytes} (bf16 pool {bf16_pool_bytes})")
    g_done = serve_gather(serve_mod.ServeEngine, params, cfg, stream, "int8", kv_int8=True)

    check_near_ties(torch, done, g_done, int8_logits_at(torch, paged, params, cfg),
                    "int8 cuda vs gather")

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
    return launches, sampled, {rid: list(r.tokens) for rid, r in g_done.items()}


def int8_logits_at(torch, paged, params, cfg):
    """``logits_at(sequence)`` for int8 serving: the near-tie margin
    recomputed through the int8 paged prefill of the sequence so far,
    each window quantized at insert and read back, as the engine's own
    prefill and decode do."""
    slots = 640  # five 128-position windows: a 512-token prompt and its 63 tokens
    prefill = paged.make_paged_prefill(cfg, slots, 128)

    def logits_at(seq):
        pool = paged.init_block_pool(cfg, 6, 128, kv_int8=True, device="cuda")
        toks = torch.zeros((1, slots), dtype=torch.int32, device="cuda")
        toks[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        table = torch.arange(1, 6, dtype=torch.int32, device="cuda")[None]
        lens = torch.tensor([len(seq)], dtype=torch.int32, device="cuda")
        return prefill(params, toks, lens, pool, table)[0][0]

    return logits_at


def prefix_stream(vocab: int):
    """16 requests sharing one 384-token prefix (3 full blocks), each
    followed by its own 16-128 random tokens, budgets 16-64; numpy seed 1."""
    import numpy as np

    rng = np.random.RandomState(1)
    shared = [int(t) for t in rng.randint(0, vocab, 384)]
    return [
        (shared + [int(t) for t in rng.randint(0, vocab, rng.randint(16, 129))],
         int(rng.randint(16, 65)))
        for _ in range(16)
    ]


def check_blocks_conserved(engines, label: str) -> None:
    """Every block's refcount equals its owners: the live table cells,
    the resident prefix entries and the parked alias payloads of
    ``engines`` (which share one allocator), scratch its own; freed rows
    point at scratch only; free + allocated + scratch == the pool."""
    balloc = engines[0]._balloc
    owners = {0: 1}
    for eng in engines:
        if eng._balloc is not balloc:
            raise AssertionError(f"{label}: engines checked together must share an allocator")
        for row, req in enumerate(eng._row_req):
            if req is None and eng._table[row].any():
                raise AssertionError(f"{label}: freed row {row} still names blocks")
        cells = [int(b) for b in eng._table.reshape(-1) if b]
        entries = eng._prefix.export_blocks() if eng._prefix is not None else []
        cells += [b for e in entries for b in e["blocks"]]
        cells += [b for st in eng._handoff_state.values() if st["mode"] == "alias"
                  for b in st["blocks"]]
        for b in cells:
            owners[b] = owners.get(b, 0) + 1
    stats = balloc.stats()
    if stats["blocks_free"] + stats["blocks_allocated"] + 1 != stats["blocks_total"]:
        raise AssertionError(f"{label}: blocks not partitioned: {stats}")
    bad = [(b, balloc.refcount(b), owners.get(b, 0)) for b in range(balloc.num_blocks)
           if balloc.refcount(b) != owners.get(b, 0)]
    if bad:
        raise AssertionError(f"{label}: (block, refcount, owners) disagree: {bad[:8]}")


def phase_prefix(torch, serve_mod, pa, params, cfg, logits_at):
    """The shared-prefix stream with the cache on through the kernel (the
    path, its launches counted), then with the cache off through the
    kernel and on through gather: tokens equal up to near-ties, aliases
    and COW copies made, 384 tokens reused on every hit, refcounts equal
    owners.  Returns the launches."""
    stream = prefix_stream(cfg.vocab)
    pa.paged_attention.launches = 0  # count only this path's launches
    eng, on, on_wall, _, synced = serve(serve_mod.ServeEngine, params, cfg, stream, "cuda",
                                        prefix_cache_slots=8)
    launches = pa.paged_attention.launches
    kv, pf = eng.kv_block_stats, eng.prefix_stats
    if kv["blocks_total"] != 81:
        raise AssertionError(f"prefix: expected the default pool of 81 blocks, got {kv}")
    if launches != eng.device_steps * cfg.n_layers:
        raise AssertionError(f"prefix: launches {launches} != {eng.device_steps} steps x layers")
    if not (kv["alias_blocks_total"] > 0 and kv["cow_blocks_total"] > 0):
        raise AssertionError(f"prefix: no alias or no COW: {kv}")
    ordered = [on[i] for i in sorted(on)]
    reused = [r.prefix_reused for r in ordered]
    if any(n not in (0, 384) for n in reused) or sum(n == 384 for n in reused[1:]) < 12:
        raise AssertionError(f"prefix: prefix_reused per request {reused}")
    check_blocks_conserved([eng], "prefix")
    log(f"prefix cache on (cuda): {len(on)} requests, {eng.device_steps} steps, {launches} kernel "
        f"launches; prefill tokens computed {pf['prefill_tokens_computed']}, reused "
        f"{pf['prefill_tokens_reused']}; hits {pf['hits']}, misses {pf['misses']}, "
        f"evictions {pf['evictions']}; blocks aliased {kv['alias_blocks_total']}, COW "
        f"{kv['cow_blocks_total']}, allocated {kv['alloc_blocks_total']}; {synced}")
    eng.close()
    off_eng, off, off_wall, _, _ = serve(serve_mod.ServeEngine, params, cfg, stream, "cuda")
    off_eng.close()
    g_eng, g_on, _, _, _ = serve(serve_mod.ServeEngine, params, cfg, stream, "gather",
                                 prefix_cache_slots=8)
    g_eng.close()
    for label, runs in (("cache on", (on, on_wall)), ("cache off", (off, off_wall))):
        done, wall = runs
        n_tok = sum(len(r.tokens) for r in done.values())
        ttft = statistics.median(r.ttft_s for r in done.values())
        log(f"prefix stream, {label} (cuda): {n_tok / wall:.3f} tokens/s, TTFT p50 "
            f"{ttft * 1e3:.3f} ms (host clocks)")
    check_near_ties(torch, on, off, logits_at, "prefix cuda, cache on vs off")
    check_near_ties(torch, on, g_on, logits_at, "prefix cache on, cuda vs gather")
    return launches


def round_trip_check(torch, paged, quant, cfg):
    """A block copied to pinned host memory and written into another
    block, as a swap or a dma handoff moves it, comes back bitwise, in
    both pool formats."""
    def leaves(tree):
        return [t for leaf in tree.values()
                for t in (leaf.values() if isinstance(leaf, dict) else [leaf])]

    for kv_int8 in (False, True):
        pool = paged.init_block_pool(cfg, 3, 128, kv_int8=kv_int8, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(4)
        for leaf in pool.values():
            x = torch.randn((leaf["q"] if kv_int8 else leaf).shape, generator=g, device="cuda")
            if kv_int8:
                row = quant.quantize_tensor(x, (4,))
                leaf["q"].copy_(row["q"])
                leaf["s"].copy_(row["s"])
            else:
                leaf.copy_(x)
        want = paged.read_block(pool, 1)
        host = paged._tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t), want)
        paged.write_block(pool, 2, host)
        torch.cuda.synchronize()
        got = paged.read_block(pool, 2)
        if not all(torch.equal(x, y) for x, y in zip(leaves(want), leaves(got))):
            raise AssertionError(f"round trip ({'int8' if kv_int8 else 'bf16'}) not bitwise")
    log("read_block -> pinned host -> write_block into another block: bitwise equal, bf16 and int8")


def phase_swap(torch, serve_mod, pa, paged, quant, params, cfg, logits_at):
    """4 priority-0 long requests fill a 21-block pool; after 4 ticks, 4
    priority-5 requests arrive and preempt through the 40-block host
    tier.  Tokens equal a roomy engine's at priority 0 up to near-ties;
    every swapped block comes back.  Returns the launches."""
    import numpy as np

    round_trip_check(torch, paged, quant, cfg)
    rng = np.random.RandomState(2)
    low = [([int(t) for t in rng.randint(0, cfg.vocab, rng.randint(448, 513))], 64)
           for _ in range(4)]
    high = [([int(t) for t in rng.randint(0, cfg.vocab, rng.randint(200, 257))], 32)
            for _ in range(4)]
    eng = serve_mod.ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                                attn_backend="cuda", kv_blocks=21)
    if eng.kv_block_stats["host_capacity"] != 40:
        raise AssertionError(f"swap: host tier {eng.kv_block_stats}")
    # Each direction's block copies timed: device to host on the host
    # clock (the engine syncs them: pinned allocations included), host to
    # device by CUDA events around the queued uploads (no sync added).
    fetched, uploads = [0, 0.0], []
    fetch, restore = eng._fetch_blocks, eng._restore_blocks

    def timed_fetch(blocks):
        t = time.perf_counter()
        out = fetch(blocks)
        fetched[0] += len(blocks)
        fetched[1] += time.perf_counter() - t
        return out

    def timed_restore(blocks, slots, host):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        restore(blocks, slots, host)
        end.record()
        uploads.append((len(blocks), start, end))

    eng._fetch_blocks, eng._restore_blocks = timed_fetch, timed_restore
    waves = count_waves([eng])
    pa.paged_attention.launches = 0  # count only this path's launches
    ids = [eng.submit(p, b, priority=0) for p, b in low]
    with host_syncs(torch) as syncs:
        for _ in range(4):
            eng.tick()
        ids += [eng.submit(p, b, priority=5) for p, b in high]
        while eng.pending:
            eng.tick()
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    synced = check_host_syncs(syncs, waves[0], [eng], "swap")
    kv = eng.kv_block_stats
    if launches != eng.device_steps * cfg.n_layers:
        raise AssertionError(f"swap: launches {launches} != {eng.device_steps} steps x layers")
    if kv["preemptions_total"] < 1 or kv["swap_in_blocks_total"] != kv["swap_out_blocks_total"]:
        raise AssertionError(f"swap: {kv}")
    if kv["blocks_host"] != 0 or kv["blocks_free"] != kv["blocks_total"] - 1:
        raise AssertionError(f"swap: blocks left behind: {kv}")
    done = {i: eng.request(rid) for i, rid in enumerate(ids)}
    block_bytes = quant.tree_bytes(paged.read_block(eng._pool, 1))
    dma_s = sum(r.swap_dma_s for r in done.values())
    blocks = kv["swap_out_blocks_total"] + kv["swap_in_blocks_total"]
    up_s = sum(start.elapsed_time(end) for _, start, end in uploads) / 1e3
    up_blocks = sum(n for n, _, _ in uploads)
    # Device to host again with the pinned buffers the run freed (the
    # caching host allocator reuses them): the copies without allocation.
    n_out, out_s = fetched
    t = time.perf_counter()
    fetch(list(range(1, n_out + 1)))
    warm_s = time.perf_counter() - t
    log(f"swap: {kv['preemptions_total']} preemptions, {kv['swap_out_blocks_total']} blocks out, "
        f"{kv['swap_in_blocks_total']} in ({block_bytes} bytes a block), {eng.device_steps} "
        f"steps, {launches} kernel launches; {synced}; swap traffic both ways "
        f"{blocks * block_bytes / dma_s / 1e9:.3f} GB/s over the requests' swap_dma_s; device "
        f"to host {n_out * block_bytes / out_s / 1e9:.3f} GB/s in the run (pinned buffers "
        f"allocated), {n_out * block_bytes / warm_s / 1e9:.3f} GB/s with them reused; host to "
        f"device {up_blocks * block_bytes / up_s / 1e9:.3f} GB/s")
    eng.close()
    roomy = serve_mod.ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                                  attn_backend="cuda")
    rids = [roomy.submit(p, b) for p, b in low + high]
    roomy.run()
    want = {i: roomy.request(rid) for i, rid in enumerate(rids)}
    roomy.close()
    check_near_ties(torch, done, want, logits_at, "swap: preempted vs roomy engine")
    return launches


def drive_handoff(pre, dec, mode, staging):
    """Tick the prefill engine, move every row it holds to the decode
    engine, tick that; blocks conserved after every round, until both
    drain."""
    while pre.pending or dec.pending:
        pre.tick()
        for row in range(pre.slots):
            if pre._row_req[row] is not None:
                dec.handoff_in(pre.handoff_out(row, mode=mode, staging=staging))
        dec.tick()
        if mode == "alias":
            check_blocks_conserved([pre, dec], "handoff alias")
        else:
            check_blocks_conserved([pre], "handoff dma, prefill")
            check_blocks_conserved([dec], "handoff dma, decode")


def phase_handoff(torch, serve_mod, swap_mod, pa, params, cfg, logits_at):
    """8 requests admitted on a prefill engine (4 slots), moved after the
    tick that admitted them, finished on a decode engine (8 slots): alias
    over one shared allocator and pool, then dma through a staging host
    pool.  Tokens equal a mono engine's up to near-ties, alias copies no
    block, blocks conserved.  Returns the launches of both runs."""
    stream = make_stream(cfg.vocab)[:8]
    mono, mono_done, _, _, _ = serve(serve_mod.ServeEngine, params, cfg, stream, "cuda")
    mono.close()
    spec = dict(prompt_slots=512, max_new_cap=64, attn_backend="cuda")
    launches = 0
    for mode in ("alias", "dma"):
        # Alias: the prefill engine's own pool is a floor-sized stand-in
        # that the decode engine's replaces.
        pre = serve_mod.ServeEngine(params, cfg, slots=4,
                                    kv_blocks=6 if mode == "alias" else None, **spec)
        dec = serve_mod.ServeEngine(params, cfg, slots=8, **spec)
        staging = None
        if mode == "alias":  # one allocator and one pool dict for both
            pre._balloc, pre._pool = dec._balloc, dec._pool
            pre._capture()  # the engine's graphs again, on the shared pool
        else:
            staging = swap_mod.HostBlockPool(4 * pre._table_cols)
        copies = []
        real = {name: getattr(serve_mod, name) for name in ("copy_block", "write_block")}
        for name, fn in real.items():
            setattr(serve_mod, name, lambda *a, _fn=fn, _name=name: copies.append(_name) or _fn(*a))
        waves = count_waves([pre, dec])
        pa.paged_attention.launches = 0  # count only this path's launches
        t = time.perf_counter()
        try:
            reqs = [pre.request(pre.submit(p, b)) for p, b in stream]
            with host_syncs(torch) as syncs:
                drive_handoff(pre, dec, mode, staging)
        finally:
            for name, fn in real.items():
                setattr(serve_mod, name, fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        synced = check_host_syncs(syncs, waves[0], [pre, dec], f"handoff {mode}",
                                  dma=len(stream) if mode == "dma" else 0)
        launches += pa.paged_attention.launches
        steps = pre.device_steps + dec.device_steps
        if pa.paged_attention.launches != steps * cfg.n_layers:
            raise AssertionError(f"handoff {mode}: launches != {steps} steps x layers")
        kv = dec.kv_block_stats
        if kv[f"handoffs_{mode}_total"] != len(stream) or any(r.handoffs != 1 for r in reqs):
            raise AssertionError(f"handoff {mode}: {kv}")
        zero_copy = not copies and kv["alias_blocks_total"] == kv["handoff_in_blocks_total"]
        if mode == "alias" and not zero_copy:
            raise AssertionError(f"handoff alias: {len(copies)} block copies, {kv}")
        if staging is not None and staging.used_count:
            raise AssertionError(f"handoff dma: {staging.used_count} staging slots left")
        log(f"handoff {mode}: {len(reqs)} requests, {kv['handoff_in_blocks_total']} blocks moved, "
            f"{len(copies)} copy_block/write_block calls, {steps} steps, "
            f"{pa.paged_attention.launches} kernel launches, {wall:.3f} s; {synced}; "
            f"{decode_paths([pre, dec], f'handoff {mode}')}")
        check_near_ties(torch, dict(enumerate(reqs)), mono_done, logits_at,
                        f"handoff {mode} vs mono engine")
        pre.close()
        dec.close()
    return launches


def timed_steps(eng):
    """Wraps ``eng``'s decode step to record each one's host wall time
    (the step ends in its blocking fetch).  Returns the list it fills."""
    walls = []

    def step(_real=eng._step_once):
        t = time.perf_counter()
        _real()
        walls.append(time.perf_counter() - t)

    eng._step_once = step
    return walls


def serving_line(done, wall, step_walls) -> str:
    n_tok = sum(len(r.tokens) for r in done.values())
    ttft = statistics.median(r.ttft_s for r in done.values())
    return (f"{n_tok / wall:.3f} tokens/s, TTFT p50 {ttft * 1e3:.3f} ms, decode step p50 "
            f"{statistics.median(step_walls) * 1e3:.3f} ms (host clocks)")


def phase_disagg(torch, disagg_mod, serve_mod, pa, params, cfg, logits_at, tokens_out):
    """The main 16-request stream through `DisaggServer`: both tiers 8
    slots (prompt_slots 512, max_new_cap 64, block 128) through the
    kernel, the decode tier 41 blocks; first with alias handoff, then dma
    through the default staging pool (one worst-case row).  Tokens equal
    the mono engine's up to near-ties; K1 launched by the decode tier
    only (steps x layers), none by the prefill tier, which makes no
    decode step; no block copied or written under alias; blocks
    conserved after every tick; host syncs as the contract gives them
    (one a prefill-tier wave, one a decode step, one a dma handoff, none
    an alias one); one weight storage for both tiers.  Returns the
    launches of each mode; puts each mode's tokens by request in
    ``tokens_out``."""
    stream = make_stream(cfg.vocab)
    mono = serve_mod.ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                                 attn_backend="cuda")
    mono_steps = timed_steps(mono)
    ids = [mono.submit(p, b) for p, b in stream]
    t = time.perf_counter()
    mono.run()
    torch.cuda.synchronize()
    mono_wall = time.perf_counter() - t
    mono_done = {i: mono.request(rid) for i, rid in enumerate(ids)}
    log(f"disagg baseline, mono engine: {serving_line(mono_done, mono_wall, mono_steps)}")
    mono.close()
    spec = dict(slots=8, prompt_slots=512, max_new_cap=64, attn_backend="cuda")
    launches = {}
    for mode in ("alias", "dma"):
        srv = disagg_mod.DisaggServer(params, cfg, prefill=dict(spec),
                                      decode=dict(spec, kv_blocks=41), handoff=mode)
        pre, dec = srv.tiers["prefill"], srv.tiers["decode"]
        ptrs = {params["layers"]["wqkv"].data_ptr(), pre.params["layers"]["wqkv"].data_ptr(),
                dec.params["layers"]["wqkv"].data_ptr()}
        if len(ptrs) != 1:
            raise AssertionError(f"disagg {mode}: the tiers do not share one wqkv storage")
        if (pre.block_size, dec.kv_block_stats["blocks_total"]) != (128, 41):
            raise AssertionError(f"disagg {mode}: block {pre.block_size}, {dec.kv_block_stats}")
        if mode == "alias" and not (pre._pool is dec._pool and pre._balloc is dec._balloc):
            raise AssertionError("disagg alias: the tiers do not share one pool")
        copies = []
        real = {name: getattr(serve_mod, name) for name in ("copy_block", "write_block")}
        for name, fn in real.items():
            setattr(serve_mod, name, lambda *a, _fn=fn, _name=name: copies.append(_name) or _fn(*a))
        prefill_launches = [0]

        def prefill_tick(_real=pre.tick):
            before = pa.paged_attention.launches
            out = _real()
            prefill_launches[0] += pa.paged_attention.launches - before
            return out

        pre.tick = prefill_tick
        dec_steps = timed_steps(dec)
        waves = count_waves([pre, dec])
        pa.paged_attention.launches = 0  # count only this path's launches
        t = time.perf_counter()
        try:
            dids = [srv.submit(p, b) for p, b in stream]
            with host_syncs(torch) as syncs:
                while srv.pending:
                    srv.tick()
                    if mode == "alias":
                        check_blocks_conserved([pre, dec], "disagg alias")
                    else:
                        check_blocks_conserved([pre], "disagg dma, prefill")
                        check_blocks_conserved([dec], "disagg dma, decode")
        finally:
            for name, fn in real.items():
                setattr(serve_mod, name, fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = launches[f"disagg {mode}"] = pa.paged_attention.launches
        stats = srv.disagg_stats()
        handed = stats["prefill"]["handoff_out_requests"]
        synced = check_host_syncs(syncs, waves[0], [pre, dec], f"disagg {mode}",
                                  dma=handed if mode == "dma" else 0)
        if pre.device_steps != 0 or prefill_launches[0] != 0:
            raise AssertionError(f"disagg {mode}: the prefill tier made {pre.device_steps} decode "
                                 f"steps and {prefill_launches[0]} kernel launches")
        if n != dec.device_steps * cfg.n_layers:
            raise AssertionError(f"disagg {mode}: launches {n} != {dec.device_steps} decode steps "
                                 f"x {cfg.n_layers} layers")
        if (handed, stats["decode"][f"handoffs_{mode}"]) != (len(stream), len(stream)):
            raise AssertionError(f"disagg {mode}: {stats}")
        kv = dec.kv_block_stats
        if mode == "alias" and (copies or kv["alias_blocks_total"] != kv["handoff_in_blocks_total"]
                                or kv["alloc_blocks_total"] != 0):
            raise AssertionError(f"disagg alias: {len(copies)} block copies, {kv}")
        if kv["blocks_free"] != kv["blocks_total"] - 1 or (srv.staging and srv.staging.used_count):
            raise AssertionError(f"disagg {mode}: blocks left behind: {kv}, {stats}")
        done = {i: srv.result(d) for i, d in enumerate(dids)}
        for i, r in done.items():
            if r.finish_reason != "budget" or len(r.tokens) != stream[i][1] or r.handoffs != 1:
                raise AssertionError(f"disagg {mode}, request {i}: {r.finish_reason}, "
                                     f"{len(r.tokens)} tokens, {r.handoffs} handoffs")
        log(f"disagg {mode}: {len(done)} requests, {kv['handoff_in_blocks_total']} blocks handed "
            f"off, {len(copies)} copy_block/write_block calls, {stats['deferred_handoffs']} "
            f"deferred handoffs; prefill tier {pre.device_steps} decode steps, "
            f"{prefill_launches[0]} kernel launches; decode tier {dec.device_steps} steps, {n} "
            f"kernel launches; {synced}; {decode_paths([pre, dec], f'disagg {mode}')}; "
            f"{serving_line(done, wall, dec_steps)}")
        check_near_ties(torch, done, mono_done, logits_at, f"disagg {mode} vs mono engine")
        tokens_out[mode] = {i: list(r.tokens) for i, r in done.items()}
        srv.close()
    return launches


def phase_warm_restart(torch, serve_mod, pa, params, cfg, logits_at):
    """The shared-prefix stream through a cold engine with
    ``prefix_cache_slots=8``; its index exported, the engine closed, a
    fresh engine warm-started from the index, the stream again.  The warm
    engine reuses 384 tokens on every request from its first admission
    on (the cold engine none on its first); tokens equal the cold
    engine's up to near-ties; the warm engine's digest claims 384 tokens
    of every prompt.  Returns the warm run's launches."""
    stream = prefix_stream(cfg.vocab)
    cold, cold_done, cold_wall, _, _ = serve(serve_mod.ServeEngine, params, cfg, stream, "cuda",
                                             prefix_cache_slots=8)
    index = cold.export_prefix_index()
    cold.close()
    if not index["entries"] or index["prefix_window"] != 128:
        raise AssertionError(f"warm restart: index of {len(index['entries'])} entries, window "
                             f"{index['prefix_window']}")
    warm_s, warmed = [], []

    def warm_start(eng):
        t = time.perf_counter()
        warmed.append(eng.warm_start(index))
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t)

    pa.paged_attention.launches = 0  # count only this path's launches
    warm, warm_done, warm_wall, _, synced = serve(serve_mod.ServeEngine, params, cfg, stream,
                                                  "cuda", before=warm_start, prefix_cache_slots=8)
    launches = pa.paged_attention.launches
    if launches != warm.device_steps * cfg.n_layers:
        raise AssertionError(f"warm restart: launches {launches} != {warm.device_steps} steps x "
                             "layers")
    order = sorted(warm_done, key=lambda i: warm_done[i].admitted_at)
    warm_reused = [warm_done[i].prefix_reused for i in order]
    cold_first = min(cold_done.values(), key=lambda r: r.admitted_at)
    if warmed[0] != len(index["entries"]) or any(n != 384 for n in warm_reused):
        raise AssertionError(f"warm restart: {warmed[0]} of {len(index['entries'])} runs warmed, "
                             f"reuse in admission order {warm_reused}")
    if cold_first.prefix_reused != 0:
        raise AssertionError(f"warm restart: the cold engine's first admission reused "
                             f"{cold_first.prefix_reused}")
    claims = [warm.prefix_digest().lookup(p)[0] for p, _ in stream]
    if any(n != 384 for n in claims):
        raise AssertionError(f"warm restart: the digest claims {claims}")
    check_blocks_conserved([warm], "warm restart")
    pf = warm.prefix_stats
    cold_wave = sum(r.admitted_at <= cold_first.first_token_at and r.prefix_reused == 384
                    for r in cold_done.values())
    log(f"warm restart: {warmed[0]} runs warmed in {warm_s[0] * 1e3:.3f} ms; warm engine "
        f"{warm.device_steps} steps, {launches} kernel launches, 384 tokens reused on "
        f"{len(warm_reused)} of {len(warm_reused)} requests, prefill tokens computed "
        f"{pf['prefill_tokens_computed']} (the warm start's included), reused "
        f"{pf['prefill_tokens_reused']}; the cold engine's first admission reused 0, and "
        f"{cold_wave} more of its first wave aliased it; the digest claims 384 of every prompt; "
        f"{synced}")
    for label, done, wall in (("cold", cold_done, cold_wall), ("warm", warm_done, warm_wall)):
        n_tok = sum(len(r.tokens) for r in done.values())
        ttft = statistics.median(r.ttft_s for r in done.values())
        log(f"warm restart, {label} engine: {n_tok / wall:.3f} tokens/s, TTFT p50 "
            f"{ttft * 1e3:.3f} ms (host clocks)")
    warm.close()
    check_near_ties(torch, warm_done, cold_done, logits_at, "warm restart vs cold engine")
    return launches

# The sampled phase's counts (admission waves, device steps, wasted
# steps, device calls) for each of SAMPLED_RUNS: its requests finish on
# their budgets, so they do not depend on the width, and
# tests/test_torch_sampled_serve.py's TestSmokeSchedule pins them on the
# CPU.  Host syncs are calls + waves.
SAMPLED_SCHEDULE = {"continuous": (8, 113, 0, 113), "tick": (8, 116, 29, 29),
                    "continuous 4 slots": (12, 181, 0, 181)}
# Two sampled runs of one stream may differ where their logits do: each
# run's logits are bf16 values that another batch shape (another cuBLAS
# kernel) may round an ulp apart.  A divergence is accepted when the two
# runs' logits at that token lie within 2 bf16 ulps of the row's largest
# logit of each other, and each run's token is its own sampler's pick from
# its own logits under the request's key.
SAMPLED_TIE = 2 ** -6
# The card's gumbel against the float64 value of -log(-log(u)) on the same
# uniforms: a float32 draw whose two logs are each within 1 ulp lies within
# 2**-22 * max(1, |g|) of it.  The reference is float64 because the CPU's
# float32 transcendentals are not one: on its first multithreaded call in
# a process, torch's CPU log (and exp, sqrt, tanh, erf) sometimes returns
# one thread's chunk of 32768 elements about 1e-4 off, and is exact on
# every later call; its float64 log is not affected.
GUMBEL_RTOL = 2 ** -21


def check_prng_bitwise(torch, prng):
    """Threefry on the card equals the CPU's bit for bit: the keys of 8
    rows (``fold_in(key(seed), pos)``), then ``bits``, ``split`` and
    ``uniform`` over a (8, 32768) draw with one key a row and over one
    (8 * 32768,) draw with one key; ``gumbel`` within ``2**-21 * max(1,
    |g|)`` of ``-log(-log(u))`` taken in float64 on those uniforms."""
    seeds = torch.arange(8, dtype=torch.int32) * 7919 - 3
    pos = torch.arange(8, dtype=torch.int32) * 97 + 64
    cpu_rows = prng.fold_in(prng.key(seeds), pos)
    gpu_rows = prng.fold_in(prng.key(seeds.cuda()), pos.cuda())
    if not torch.equal(gpu_rows.cpu(), cpu_rows):
        raise AssertionError("prng: per-row keys differ between the card and the CPU")
    tiny = torch.finfo(torch.float32).tiny
    one = prng.key(1234)
    worst = 0.0
    for label, ck, gk, shape in (("(8, 32768), a key a row", cpu_rows, gpu_rows, (32768,)),
                                 ("(262144,), one key", one, one.cuda(), (8 * 32768,))):
        draws = {
            "bits": lambda k: prng.bits(k, shape),
            "split": lambda k: prng.split(k, 5),
            "uniform": lambda k: prng.uniform(k, shape, minval=tiny).view(torch.int32),
        }
        for name, fn in draws.items():
            if not torch.equal(fn(gk).cpu(), fn(ck)):
                raise AssertionError(f"prng {name} {label}: the card's differs from the CPU's")
        u = prng.uniform(ck, shape, minval=tiny).double()
        exact = -torch.log(-torch.log(u))
        got = prng.gumbel(gk, shape).cpu()
        rel = (got.double() - exact).abs() / exact.abs().clamp(min=1)
        err = rel.max().item()
        if err > GUMBEL_RTOL:
            i = int(rel.flatten().argmax())
            raise AssertionError(
                f"prng gumbel {label}: relative error {err} > {GUMBEL_RTOL} at "
                f"{int((rel > GUMBEL_RTOL).sum())} elements; the worst at u "
                f"{u.flatten()[i].item()!r}: card {got.flatten()[i].item()!r}, float64 "
                f"{exact.flatten()[i].item()!r}")
        worst = max(worst, err)
    log(f"prng on the card: keys, bits, split and uniform bitwise equal to the CPU's over "
        f"(8, 32768) with a key a row and (262144,) with one key; gumbel max relative error "
        f"{worst} against float64")


def check_filter_mask(torch, decode, logits):
    """The card's top-k/top-p keep mask equals the CPU's on one step's
    logits, except where a token's exclusive top-p mass is within 1e-6 of
    p (the two cumulative sums round in their own order)."""
    T, k, p = SAMPLING["temperature"], SAMPLING["top_k"], SAMPLING["top_p"]
    scaled = logits / T
    got = torch.isfinite(decode.filter_logits(scaled, top_k=k, top_p=p)).cpu()
    want = torch.isfinite(decode.filter_logits(scaled.cpu(), top_k=k, top_p=p))
    srt, order = torch.sort(scaled.cpu().double(), dim=-1, descending=True, stable=True)
    probs = torch.softmax(srt, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    unsure = torch.zeros_like(want).scatter(-1, order, (before - p).abs() <= 1e-6)
    bad = (got != want) & ~unsure
    if bad.any():
        raise AssertionError(f"filter mask: {int(bad.sum())} tokens differ card vs CPU")
    log(f"filter mask card vs CPU on one step's (8, 32768) logits: equal, {int(got.sum())} kept, "
        f"{int(unsure.sum())} within 1e-6 of the top-p boundary")


def record_picks(eng, picks):
    """Keeps every pick the engine makes (admission waves and decode
    steps): device copies of the logits, seeds, positions and tokens, no
    sync, and which rows held a request (a decode step also picks for
    idle rows).  `pick_table` indexes them after the run."""
    in_step = [False]

    def step(_real=eng._step_once):
        in_step[0] = True
        try:
            _real()
        finally:
            in_step[0] = False

    def sample(logits, seeds, positions, _real=eng._sample):
        toks = _real(logits, seeds, positions)
        live = ([r is not None for r in eng._row_req] if in_step[0]
                else [True] * logits.shape[0])
        picks.append((logits.clone(), seeds.clone(), positions.clone(), toks.clone(), live))
        return toks

    eng._step_once = step
    eng._sample = sample


def pick_table(picks):
    """``{(seed, position): (logits row, token)}`` of the recorded picks
    of rows that held a request (a stream's seeds are its request ids, so
    the key names one token of one request)."""
    table = {}
    for logits, seeds, positions, toks, live in picks:
        for b, (seed, pos, tok) in enumerate(zip(seeds.tolist(), positions.tolist(),
                                                toks.tolist())):
            if live[b]:
                table[(seed, pos)] = (logits[b], tok)
    return table


def check_sampled_runs(torch, prng, decode, base, other, stream, tables, label) -> int:
    """Per request, ``other``'s tokens equal ``base``'s up to the first
    divergence; there the two runs' recorded logits must lie within
    ``SAMPLED_TIE * max|logit|`` of each other and each run's token be its
    sampler's pick from its own logits under the request's key.  Returns
    the requests equal throughout."""
    pick = decode._make_pick(True, SAMPLING["temperature"], SAMPLING["top_k"], SAMPLING["top_p"])
    equal = 0
    for rid, r in base.items():
        a, b = r.tokens, other[rid].tokens
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        if i is None:
            equal += 1
            continue
        where = (r.seed, len(stream[rid][0]) + i)
        (la, ta), (lb, tb) = tables[0][where], tables[1][where]
        key = prng.fold_in(prng.key(r.seed), where[1]).to(la.device)[None]
        err = (la - lb).abs().max().item()
        tol = SAMPLED_TIE * la.abs().max().item()
        picks = (int(pick(la[None], key)[0]), int(pick(lb[None], key)[0]))
        log(f"{label}, request {rid}: tokens differ first at {i} ({a[i]} vs {b[i]}); the runs' "
            f"logits there differ by {err} (tolerance {tol}); each run's own pick {picks}")
        if (ta, tb) != (a[i], b[i]) or err > tol or picks != (a[i], b[i]):
            raise AssertionError(f"{label}, request {rid}: tokens differ at {i}, not explained "
                                 "by the runs' logits")
    return equal


def check_logprobs(torch, decode, done, stream, table, positions: int = 8) -> float:
    """Every logprob finite and at most 0, one a token; at ``positions``
    recorded picks, equal to log_softmax of that pick's logits at its
    token within 1e-5.  Returns the worst error."""
    for r in done.values():
        if len(r.logprobs) != len(r.tokens) or not all(
                math.isfinite(lp) and lp <= 0 for lp in r.logprobs):
            raise AssertionError(f"request {r.id}: logprobs {r.logprobs[:4]}...")
    worst = 0.0
    chosen = sorted(table)[::max(1, len(table) // positions)][:positions]
    for seed, pos in chosen:
        row, tok = table[(seed, pos)]
        want = torch.log_softmax(row.float(), dim=-1)[tok].item()
        worst = max(worst, abs(done[seed].logprobs[pos - len(stream[seed][0])] - want))
    if len(chosen) < positions or worst > 1e-5:
        raise AssertionError(f"logprobs vs log_softmax of the pick's logits: {len(chosen)} "
                             f"positions, max abs err {worst}")
    return worst


def sampler_times(torch, prng, decode, eng, logits, seeds, positions, flush):
    """The sampler's time a step on one step's (8, 32768) logits: kernel
    time (a profile of 8 calls), event time (the median of 20, the host's
    dispatch hidden behind a device spin) and host time (20 calls back to
    back, then a sync) of the keys and the gumbel draw (Threefry), of the
    filter (the sort, softmax, cumsum, scatter), and of the whole pick
    with its logprob.  Returns the whole pick's kernel time."""
    from torch.profiler import ProfilerActivity, profile

    V = logits.shape[-1]
    T, k, p = SAMPLING["temperature"], SAMPLING["top_k"], SAMPLING["top_p"]
    parts = {
        "keys + gumbel (threefry)": lambda: prng.gumbel(prng.fold_in(prng.key(seeds), positions),
                                                        (V,)),
        "filter (sort, softmax, cumsum, scatter)": lambda: decode.filter_logits(
            logits / T, top_k=k, top_p=p),
        "whole pick + logprob": lambda: decode._chosen_logprob(
            logits, eng._sample(logits, seeds, positions)),
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                fn()
            torch.cuda.synchronize()
        kernels = trace_kernels(prof, "chip_smoke_sampler_trace.json")
        kernel_ms = sum(float(e["dur"]) for e in kernels) / 8 / 1e3 if kernels else float("nan")
        event_ms = time_ms(fn, flush, n=20, warmup=3)
        # Host clock over 20 back-to-back calls and one sync: the larger of
        # the host's dispatch and the device's work, a call.
        t = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) / 20 * 1e3
        out[name] = kernel_ms
        log(f"sampler, {name}: kernel time {kernel_ms:.4f} ms, {len(kernels) // 8} kernels, "
            f"event time {event_ms:.4f} ms, host time {host_ms:.4f} ms a step of 8 rows")
    return out["whole pick + logprob"]


def phase_sampling(torch, serve_mod, prng, decode, pa, params, cfg, greedy_line):
    """Sampled serving at full width (bf16, K1): Threefry on the card
    against the CPU's; the main stream at temperature 0.8, top_k 50, top_p
    0.95 with logprobs, three ways (continuous at 8 slots, fused ticks of
    4, continuous at 4 slots), each run's K1 launches counted from 0 and
    equal to steps x layers, its counts the CPU schedule test's; tokens
    equal across the runs but where their logits differ (each run's picks
    recorded); the filter mask against the CPU's; logprobs against the
    pick's logits; the sampler's device time.  Returns the launches of
    each run."""
    stream = make_stream(cfg.vocab)
    check_prng_bitwise(torch, prng)
    serve(serve_mod.ServeEngine, params, cfg, stream[:2], "cuda", warm_up=True,
          **SAMPLING)[0].close()
    runs, launches, tables = {}, {}, {}
    for label, kw in SAMPLED_RUNS.items():
        box = {"picks": []}

        def before(eng, box=box):
            record_picks(eng, box["picks"])
            box["walls"] = timed_steps(eng)
            box["waves"] = count_waves([eng])

        pa.paged_attention.launches = 0  # count only this run's launches
        eng, done, wall, _, synced = serve(serve_mod.ServeEngine, params, cfg, stream, "cuda",
                                           before=before, **SAMPLING, **kw)
        n = launches[f"sampled {label}"] = pa.paged_attention.launches
        counts = (box["waves"][0], eng.device_steps, eng.wasted_steps, device_calls(eng))
        if counts != SAMPLED_SCHEDULE[label]:
            raise AssertionError(f"sampled {label}: (waves, steps, wasted, calls) {counts}, the CPU "
                                 f"schedule test pins {SAMPLED_SCHEDULE[label]}")
        if n != eng.device_steps * cfg.n_layers:
            raise AssertionError(f"sampled {label}: launches {n} != {eng.device_steps} steps x "
                                 f"{cfg.n_layers} layers")
        for r in done.values():
            if r.finish_reason != "budget" or not all(0 <= t < cfg.vocab for t in r.tokens):
                raise AssertionError(f"sampled {label}, request {r.id}: {r.finish_reason}")
        per_step = [w / (kw.get("steps_per_tick", 1) if kw.get("scheduling") == "tick" else 1)
                    for w in box["walls"]]
        log(f"sampled {label}: {len(done)} requests, waves/steps/wasted/calls {counts}, {n} "
            f"kernel launches; {serving_line(done, wall, per_step)}; {synced}")
        runs[label], tables[label] = done, pick_table(box["picks"])
        if label == "continuous":
            # A decode step's picks with all 8 rows live (after the first wave).
            step = next(p for p in box["picks"][1:] if all(p[4]) and len(p[4]) == 8)
        eng.close()
    log(f"greedy engine (phase engine): {greedy_line}")
    base = runs["continuous"]
    for label in ("tick", "continuous 4 slots"):
        equal = check_sampled_runs(torch, prng, decode, base, runs[label], stream,
                                   (tables["continuous"], tables[label]),
                                   f"sampled {label} vs continuous")
        log(f"sampled {label} vs continuous: {equal} of {len(base)} requests equal throughout")
    err = check_logprobs(torch, decode, base, stream, tables["continuous"])
    log(f"logprobs: all finite and <= 0; at 8 picks vs log_softmax of the pick's logits: "
        f"max abs err {err}")
    logits, seeds, positions, _, _ = step
    check_filter_mask(torch, decode, logits)
    del tables, runs

    step_ms = profile_decode(torch, serve_mod.ServeEngine, params, cfg, **SAMPLING)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda").zero_
    eng = serve_mod.ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                                **SAMPLING)
    pick_ms = sampler_times(torch, prng, decode, eng, logits, seeds, positions, flush)
    eng.close()
    if step_ms:
        log(f"sampler share of a sampled decode step's kernel time: {pick_ms:.4f} of "
            f"{step_ms:.4f} ms ({pick_ms / step_ms:.4f})")
    return launches


def speculative_rounds(spec_mod, fn, *args):
    """``fn(*args)`` (a with_stats speculative generator) with its verify
    frontiers recorded: returns its outputs and the accepted draft
    tokens of every round but the last (whose commit the output cuts)."""
    frontiers = []
    real = spec_mod.decode_forward

    def recording(params, tokens, cache, p0, cfg):
        if tokens.shape[1] > 1 and p0:  # a verify pass (the prefill starts at 0)
            frontiers.append(p0)
        return real(params, tokens, cache, p0, cfg)

    spec_mod.decode_forward = recording
    try:
        out = fn(*args)
    finally:
        spec_mod.decode_forward = real
    return out, [b - a - 1 for a, b in zip(frontiers, frontiers[1:])]


def phase_speculative(torch, decode, spec_mod, prng, params, cfg, logits_at):
    """Speculative decoding at full width on a contiguous cache (no K1):
    prompts of 128 tokens, 64 new, a 2-layer draft proposing 4 a round, at
    B=1 and B=4.  Greedy output equals `make_generate`'s up to the first
    divergence, which is a near-tie of the dense forward's logits (the
    verify pass's S=5 products and the decode step's S=1 products are
    other cuBLAS shapes); rounds, tokens a full-model pass and wall time
    against `make_generate`'s.  Then sampled at temperature 0.8 (healthy,
    its acceptance rate), and a full-depth draft, greedy and sampled,
    whose acceptance rate must be at least 0.95."""
    import numpy as np

    P, N, K = 128, 64, 4
    rng = np.random.RandomState(5)
    prompts = torch.tensor(rng.randint(0, cfg.vocab, (4, P)), dtype=torch.int32, device="cuda")
    gen = decode.make_generate(cfg, prompt_len=P, steps=N)
    kw = dict(prompt_len=P, steps=N, draft_len=K, with_stats=True)
    spec = spec_mod.make_generate_speculative(cfg, draft_layers=2, **kw)
    gen(params, prompts[:1])  # warm-up: cuBLAS handles and shapes
    spec(params, prompts[:1])
    for B in (1, 4):
        prompt = prompts[:B]
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = gen(params, prompt)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t
        t = time.perf_counter()
        (got, rounds, ok), accepted = speculative_rounds(spec_mod, spec, params, prompt)
        spec_wall = time.perf_counter() - t
        if not bool(ok) or got.shape != (B, P + N):
            raise AssertionError(f"speculative B={B}: healthy {bool(ok)}, shape {tuple(got.shape)}")
        want_rows = {b: _Gen(want[b, P:].tolist(), prompt[b].tolist()) for b in range(B)}
        got_rows = {b: _Gen(got[b, P:].tolist(), prompt[b].tolist()) for b in range(B)}
        check_near_ties(torch, got_rows, want_rows, logits_at,
                        f"speculative greedy B={B} vs make_generate")
        rate = sum(accepted) / (K * len(accepted)) if accepted else float("nan")
        log(f"speculative greedy B={B}, 2-layer draft: {rounds} rounds, {N / rounds:.3f} tokens "
            f"a full-model pass, acceptance {rate:.4f}; wall {spec_wall * 1e3:.3f} ms against "
            f"make_generate's {gen_wall * 1e3:.3f} ms")
    sampled = spec_mod.make_generate_speculative(cfg, draft_layers=2, temperature=0.8, **kw)
    (got, rounds, ok), accepted = speculative_rounds(spec_mod, sampled, params, prompts,
                                                     prng.key(7))
    if not bool(ok) or not bool(((got >= 0) & (got < cfg.vocab)).all()):
        raise AssertionError(f"speculative sampled: healthy {bool(ok)} or tokens out of range")
    log(f"speculative sampled B=4 at T=0.8, 2-layer draft: {rounds} rounds, "
        f"acceptance {sum(accepted) / (K * len(accepted)):.4f}")
    for T in (0.0, 0.8):
        full = spec_mod.make_generate_speculative(cfg, draft_layers=cfg.n_layers, temperature=T,
                                                  **kw)
        args = (params, prompts[:1]) + ((prng.key(7),) if T else ())
        (got, rounds, ok), accepted = speculative_rounds(spec_mod, full, *args)
        rate = sum(accepted) / (K * len(accepted))
        if not bool(ok) or rate < 0.95:
            raise AssertionError(f"speculative full-depth draft T={T}: acceptance {rate} < 0.95 "
                                 f"or unhealthy ({bool(ok)})")
        log(f"speculative full-depth draft B=1 T={T}: {rounds} rounds, acceptance {rate:.4f}")


def phase_sampled(torch, cfg_mod, serve_mod, prng, decode, spec_mod, weights, pa, greedy_line):
    """Sampled serving and speculative decoding on the serving width's
    seeded weights.  Returns K1's launches on the sampled paths."""
    cfg = cfg_mod.BurninConfig(**SERVE_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = weights.cast_matrices(cfg_mod.init_params(cfg, gen, device="cuda"))
    logits_at = dense_logits_at(cfg_mod, params, cfg)
    t = time.perf_counter()
    launches = phase_sampling(torch, serve_mod, prng, decode, pa, params, cfg, greedy_line)
    log(f"phase sampling: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    with torch.no_grad():
        phase_speculative(torch, decode, spec_mod, prng, params, cfg, logits_at)
    log(f"phase speculative: {time.perf_counter() - t:.3f} s")
    return launches


@dataclasses.dataclass
class _Gen:
    """A generated row in the shape `check_near_ties` reads."""

    tokens: list
    prompt: list


def phase_kv_hierarchy(torch, cfg_mod, serve_mod, swap_mod, disagg_mod, weights, quant, pa,
                       paged, disagg_tokens):
    """The KV hierarchy and the tiers at the serving width: prefix cache,
    swap tier, handoff, the disaggregated server, warm restart, each
    timed.  Returns the kernel's launches on their paths; puts the
    disaggregated server's tokens in ``disagg_tokens``."""
    cfg = cfg_mod.BurninConfig(**SERVE_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = weights.cast_matrices(cfg_mod.init_params(cfg, gen, device="cuda"))
    logits_at = dense_logits_at(cfg_mod, params, cfg)
    launches = {}
    for name, run in (
        ("prefix", lambda: phase_prefix(torch, serve_mod, pa, params, cfg, logits_at)),
        ("swap", lambda: phase_swap(torch, serve_mod, pa, paged, quant, params, cfg, logits_at)),
        ("handoff", lambda: phase_handoff(torch, serve_mod, swap_mod, pa, params, cfg, logits_at)),
        ("disagg", lambda: phase_disagg(torch, disagg_mod, serve_mod, pa, params, cfg,
                                        logits_at, disagg_tokens)),
        ("warm restart", lambda: phase_warm_restart(torch, serve_mod, pa, params, cfg,
                                                    logits_at)),
    ):
        t = time.perf_counter()
        out = run()
        launches.update(out if isinstance(out, dict) else {name: out})
        log(f"phase {name}: {time.perf_counter() - t:.3f} s")
    return launches


# -- the serve fleet ----------------------------------------------------------
# bench.py's serve_fleet stanza at the engine's width: FLEET_FAMILIES system
# prompts of 384 tokens (3 blocks), FLEET_REQUESTS requests, request i is
# family i mod 5 followed by its own 16-64 random tokens, a budget of
# FLEET_BUDGET each (numpy seed 3).  Fleets of 1, 2 and 4 replicas on the
# affinity router and of 4 on the seeded random one (the control arm),
# FLEET_ROUNDS passes each, interleaved across the fleets: the first cold
# (one request a family, then the rest as one burst), the others steady
# (the whole stream as one burst).  Each replica is a paged kernel engine
# whose prefix cache holds 3 entries, all of them built on one cast tree.
# The replicas of a fleet drain in threads, as `ServeFleet.run` drains
# them; "n4-lockstep" is the 4-replica fleet ticked in one thread
# (``parallel_ticks=False``), the threads' own cost beside it.
FLEET_FAMILIES, FLEET_REQUESTS, FLEET_BUDGET, FLEET_ROUNDS = 5, 40, 16, 3
FLEET_SIZES = (("n1", 1, "affinity", True), ("n2", 2, "affinity", True),
               ("n4", 4, "affinity", True), ("rand4", 4, "random", True),
               ("n4-lockstep", 4, "affinity", False))
FLEET_REPLICA = dict(slots=8, prompt_slots=512, max_new_cap=64, prefix_window=128,
                     prefix_cache_slots=3, telemetry=False)


def fleet_stream(vocab: int):
    """The stanza's stream (`FLEET_REQUESTS` prompts) and its warm-up
    prefix, from numpy seed 3."""
    import numpy as np

    rng = np.random.RandomState(3)
    systems = [[int(t) for t in rng.randint(0, vocab, 384)] for _ in range(FLEET_FAMILIES)]
    stream = [systems[i % FLEET_FAMILIES]
              + [int(t) for t in rng.randint(0, vocab, rng.randint(16, 65))]
              for i in range(FLEET_REQUESTS)]
    return stream, [int(t) for t in rng.randint(0, vocab, 384)]


class EngineSyncs:
    """Host syncs and admission waves charged to the engine whose tick made
    them, for replicas that tick in the fleet's worker threads: each
    watched engine's ``tick`` names it in a thread-local, and a sync
    warning (PyTorch's sync debug mode) made outside every tick is
    charged to ``""``."""

    def __init__(self):
        self._local = threading.local()
        self.syncs: "dict[str, int]" = {"": 0}
        self.where: "dict[str, dict]" = {"": {}}
        self.waves: "dict[str, int]" = {}

    def watch(self, eng) -> None:
        name = eng.name
        self.syncs[name], self.where[name], self.waves[name] = 0, {}, 0

        def tick(_real=eng.tick):
            self._local.name = name
            try:
                return _real()
            finally:
                self._local.name = ""

        def admit(_real=eng._admit):
            admitted, hits = _real()
            self.waves[name] += admitted > 0
            return admitted, hits

        eng.tick, eng._admit = tick, admit

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            name = getattr(self._local, "name", "")
            where = f"{os.path.basename(filename)}:{lineno}"
            self.syncs[name] += 1
            self.where[name][where] = self.where[name].get(where, 0) + 1

    @contextlib.contextmanager
    def counting(self, torch):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def check(self, engines, label: str) -> str:
        """Every watched engine held to the host-sync contract
        (`check_host_syncs`), none made outside a tick.  Returns the
        counts as text."""
        if self.syncs[""]:
            raise AssertionError(f"{label}: {self.syncs['']} host syncs outside every replica's "
                                 f"tick ({self.where['']})")
        for eng in engines:
            check_host_syncs((self.syncs[eng.name], self.where[eng.name]), self.waves[eng.name],
                             [eng], f"{label}, replica {eng.name}")
        return (f"{sum(self.syncs.values())} host syncs = "
                f"{sum(device_calls(e) for e in engines)} device calls + "
                f"{sum(self.waves.values())} admission waves, each replica's its own")


def new_fleet(ServeFleet, ServeEngine, params_on, cfg, n, policy, tag, devices, warm, syncs,
              parallel_ticks=True):
    """``n`` replicas, replica r on ``devices[r % len(devices)]`` over that
    device's weights in ``params_on``, each warmed by a miss and a hit on
    ``warm`` (the prefix path's first use off the record) and watched by
    ``syncs``; caps wide open, so a burst places up front."""
    engines = []
    for r in range(n):
        dev = devices[r % len(devices)]
        eng = ServeEngine(params_on[dev], cfg, name=f"{tag}-{r}", device=dev,
                          attn_backend="cuda", **FLEET_REPLICA)
        syncs.watch(eng)
        for k in (1, 2):
            eng.submit(warm + [k], 2)
        while eng.pending:
            eng.tick()
        engines.append(eng)
    return ServeFleet(engines, policy=policy, seed=9, name=f"fleet-{tag}",
                      max_queue_per_replica=FLEET_REQUESTS, parallel_ticks=parallel_ticks)


def fleet_pass(pa, fleet, stream, cold: bool) -> dict:
    """One timed pass of the stream through ``fleet`` (the stanza's cold
    or steady protocol), ending when every request has its last token on
    the host.  Returns the requests in stream order and the pass's
    numbers: tokens/s and TTFT p50 (host clock), prefill tokens reused
    and computed, device steps and K1 launches."""
    before = {n: (fleet.engine(n).prefix_stats, fleet.engine(n).device_steps)
              for n in fleet.replicas}
    launches = pa.paged_attention.launches
    t0 = time.perf_counter()
    if cold:
        fids = [fleet.submit(p, FLEET_BUDGET) for p in stream[:FLEET_FAMILIES]]
        fleet.run()
        fids += [fleet.submit(p, FLEET_BUDGET) for p in stream[FLEET_FAMILIES:]]
    else:
        fids = [fleet.submit(p, FLEET_BUDGET) for p in stream]
    hint = fleet.scale_hint()["hint"]
    fleet.run()
    wall = time.perf_counter() - t0
    reqs = [fleet.result(f) for f in fids]
    for r in reqs:
        if r.finish_reason != "budget" or len(r.tokens) != FLEET_BUDGET:
            raise AssertionError(f"{fleet.name}: a request ended {r.finish_reason} after "
                                 f"{len(r.tokens)} tokens")
    delta = {k: 0 for k in ("prefill_tokens_reused", "prefill_tokens_computed", "hits", "misses")}
    steps = 0
    for n, (stats, s0) in before.items():
        now = fleet.engine(n).prefix_stats
        for k in delta:
            delta[k] += now[k] - stats[k]
        steps += fleet.engine(n).device_steps - s0
    n_tok = sum(len(r.tokens) for r in reqs)
    return {"reqs": reqs, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_p50_s": statistics.median(r.ttft_s for r in reqs), "hint_under_load": hint,
            "steps": steps, "launches": pa.paged_attention.launches - launches, **delta}


def drive_fleets(pa, fleets, stream) -> dict:
    """`FLEET_ROUNDS` passes of every fleet, interleaved (round 0 cold);
    K1's launches counted from 0 over them all, each fleet's read pass by
    pass.  Returns the passes by fleet tag and the launches in all."""
    pa.paged_attention.launches = 0
    passes = {tag: [] for tag in fleets}
    for rnd in range(FLEET_ROUNDS):
        for tag, fleet in fleets.items():
            passes[tag].append(fleet_pass(pa, fleet, stream, cold=rnd == 0))
    return {"passes": passes, "launches": pa.paged_attention.launches}


def serve_fleets(torch, pa, fleet_mod, serve_mod, params_on, cfg, specs, label: str):
    """Build the fleets of ``specs`` (``(tag, replicas, policy, threads,
    devices)``) and drive them (`drive_fleets`) on the stanza's stream
    with every replica's host syncs counted; K1's launches and the host
    syncs checked.  Returns the fleets by tag, the drive and K1's launches
    by fleet."""
    stream, warm = fleet_stream(cfg.vocab)
    syncs = EngineSyncs()
    with syncs.counting(torch):
        fleets = {tag: new_fleet(fleet_mod.ServeFleet, serve_mod.ServeEngine, params_on, cfg, n,
                                 policy, tag, devices, warm, syncs, threads)
                  for tag, n, policy, threads, devices in specs}
        drive = drive_fleets(pa, fleets, stream)
    engines = [fleet.engine(n) for fleet in fleets.values() for n in fleet.replicas]
    launches = check_fleet_launches(drive, cfg, label)
    log(f"{label}: {syncs.check(engines, label)}; K1 launches {launches}; "
        f"{decode_paths(engines, label)}")
    return fleets, drive, launches


def check_fleet_launches(drive, cfg, label: str) -> dict:
    """K1 on every replica's decode step: each pass's launches equal its
    replicas' device steps x layers, and so does the whole run's count.
    Returns the launches by fleet."""
    by_fleet = {}
    for tag, passes in drive["passes"].items():
        for i, p in enumerate(passes):
            if p["launches"] != p["steps"] * cfg.n_layers:
                raise AssertionError(f"{label} {tag} pass {i}: {p['launches']} K1 launches != "
                                     f"{p['steps']} device steps x {cfg.n_layers} layers")
        by_fleet[f"fleet {tag}"] = sum(p["launches"] for p in passes)
    steps = sum(p["steps"] for passes in drive["passes"].values() for p in passes)
    if drive["launches"] != steps * cfg.n_layers:
        raise AssertionError(f"{label}: {drive['launches']} K1 launches != {steps} device steps x "
                             f"{cfg.n_layers} layers")
    return by_fleet


def fleet_numbers(fleet, passes) -> dict:
    """A fleet's numbers: tokens/s and TTFT p50 of the steady passes
    (their p50), each pass's, the prefill tokens reused and computed over
    every pass, its placements by reason and its affinity rate."""
    steady, st = passes[1:], fleet.fleet_stats()
    return {
        "replicas": len(fleet.replicas), "policy": fleet.router.policy,
        "tokens_per_s": statistics.median(p["tokens_per_s"] for p in steady),
        "ttft_p50_s": statistics.median(p["ttft_p50_s"] for p in steady),
        "passes": [{k: v for k, v in p.items() if k != "reqs"} for p in passes],
        "prefill_tokens_reused": sum(p["prefill_tokens_reused"] for p in passes),
        "prefill_tokens_computed": sum(p["prefill_tokens_computed"] for p in passes),
        "routed": st["routed"],
        "affinity_rate": round(st["routed"].get("affinity", 0) / st["requests"], 3),
    }


def fleet_line(num) -> str:
    each = ", ".join(f"{p['tokens_per_s']:.3f}" for p in num["passes"])
    return (f"{num['replicas']} x {num['policy']}, steady p50 {num['tokens_per_s']:.3f} tokens/s, "
            f"TTFT p50 {num['ttft_p50_s'] * 1e3:.3f} ms (passes {each} tokens/s; host clocks)")


def check_debug_fleet(metrics, fleets) -> dict:
    """``/debug/fleet`` of a `MetricsServer` for each fleet: 200, and its
    summary the fleet's `fleet_stats()` (placements by replica and by
    reason, one a request)."""
    import urllib.request

    server = metrics.MetricsServer("127.0.0.1:0")
    server.start()
    try:
        for tag, fleet in fleets.items():
            url = f"http://127.0.0.1:{server.port}/debug/fleet?fleet={fleet.name}&limit=4096"
            with urllib.request.urlopen(url, timeout=30) as r:
                status, doc = r.status, json.loads(r.read().decode())
            st = fleet.fleet_stats()
            s = doc["summary"]
            want = ({n: row["placements"] for n, row in st["replicas"].items()},
                    dict(sorted(st["routed"].items())), st["requests"])
            if status != 200 or (s["by_replica"], s["by_reason"], s["placements"]) != want:
                raise AssertionError(f"/debug/fleet {tag}: {status} {s}, fleet_stats {want}")
    finally:
        server.stop()


def check_fleet_tokens(torch, drive, want_of, logits_at, label: str) -> None:
    """Every pass's tokens against ``want_of(tag, round)`` (rows by stream
    index), up to near-ties (`check_near_ties`)."""
    for tag, passes in drive["passes"].items():
        for rnd, p in enumerate(passes):
            got = {i: r for i, r in enumerate(p["reqs"])}
            check_near_ties(torch, got, want_of(tag, rnd), logits_at, f"{label} {tag} pass {rnd}")


def phase_fleet(torch, cfg_mod, serve_mod, weights, quant, pa, fleet_mod, metrics):
    """The serve fleet at full width on one card (`FLEET_SIZES`,
    `FLEET_ROUNDS` passes each): every request's tokens against one
    engine's on the same prompt up to near-ties, K1 on every replica's
    decode step (launches == device steps x layers, pass by pass), each
    replica's host syncs its own contract's, one weight storage for every
    replica, ``/debug/fleet`` answering each fleet's `fleet_stats()`.
    Returns K1's launches by fleet."""
    cfg = cfg_mod.BurninConfig(**SERVE_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = weights.cast_matrices(cfg_mod.init_params(cfg, gen, device="cuda"))
    logits_at = dense_logits_at(cfg_mod, params, cfg)
    stream = fleet_stream(cfg.vocab)[0]
    one, one_done, one_wall, one_steps, synced = serve(
        serve_mod.ServeEngine, params, cfg, [(p, FLEET_BUDGET) for p in stream], "cuda")
    one.close()
    log(f"fleet stream through one engine (cache off, cuda): "
        f"{serving_line(one_done, one_wall, one_steps)}; {synced}")
    fleets, drive, launches = serve_fleets(
        torch, pa, fleet_mod, serve_mod, {"cuda": params}, cfg,
        [(*size, ["cuda"]) for size in FLEET_SIZES], "fleet")
    engines = [fleet.engine(n) for fleet in fleets.values() for n in fleet.replicas]
    ptrs = {e.params["layers"]["wqkv"].data_ptr() for e in engines}
    if ptrs != {params["layers"]["wqkv"].data_ptr()}:
        raise AssertionError(f"fleet: the replicas do not share one wqkv storage: {len(ptrs)}")
    check_fleet_tokens(torch, drive, lambda tag, rnd: one_done, logits_at, "fleet")
    check_debug_fleet(metrics, fleets)
    numbers = {tag: fleet_numbers(fleets[tag], drive["passes"][tag]) for tag in fleets}
    weight_bytes = quant.tree_bytes(params)
    pools = {e.name: quant.tree_bytes(e._pool) for e in engines}
    for tag, num in numbers.items():
        log(f"fleet {tag}: {fleet_line(num)}; prefill tokens reused "
            f"{num['prefill_tokens_reused']}, computed {num['prefill_tokens_computed']}; "
            f"placements {num['routed']}, affinity rate {num['affinity_rate']}")
    log(f"fleet, 4 replicas: TTFT p50 affinity {numbers['n4']['ttft_p50_s'] * 1e3:.3f} ms against "
        f"random {numbers['rand4']['ttft_p50_s'] * 1e3:.3f} ms; tokens/s "
        f"{numbers['n4']['tokens_per_s']:.3f} against {numbers['rand4']['tokens_per_s']:.3f}; "
        f"aggregate over one replica: 2 replicas "
        f"{numbers['n2']['tokens_per_s'] / numbers['n1']['tokens_per_s']:.4f}x, 4 replicas "
        f"{numbers['n4']['tokens_per_s'] / numbers['n1']['tokens_per_s']:.4f}x; 4 replicas "
        f"ticked in one thread {numbers['n4-lockstep']['tokens_per_s']:.3f} tokens/s against "
        f"{numbers['n4']['tokens_per_s']:.3f} in threads")
    log(f"fleet memory: weights {weight_bytes} bytes once, shared by {len(engines)} replicas; "
        f"each replica's pool {sorted(set(pools.values()))} bytes ({sum(pools.values())} in all); "
        f"allocated on the card {torch.cuda.memory_allocated()} bytes")
    log("fleet numbers: " + json.dumps(numbers))
    for fleet in fleets.values():
        fleet.close()
    return launches


def to_device(tree, dev):
    """A copy of a params tree on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_cards_fleet(torch, burnin, serve_mod, weights, quant, pa, fleet_mod, cards: int) -> dict:
    """``--cards N``, the serve fleet: 4 replicas, one on each of the
    first 4 cards (the weights copied to each), drained in threads and
    ticked in one thread, against 4 replicas on card 0, on phase_fleet's
    stream, the passes interleaved: the cards' tokens the one-card
    fleet's up to near-ties pass by pass, K1 launches == device steps x
    layers, each replica's host syncs its own contract's, its weights and
    pool on its own card.  Returns the fleets' numbers."""
    cfg = burnin.BurninConfig(**SERVE_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = weights.cast_matrices(burnin.init_params(cfg, gen, device="cuda:0"))
    logits_at = dense_logits_at(burnin, params, cfg)
    devices = [f"cuda:{k}" for k in range(4)]
    params_on = {"cuda:0": params, **{d: to_device(params, d) for d in devices[1:]}}
    fleets, drive, launches = serve_fleets(
        torch, pa, fleet_mod, serve_mod, params_on, cfg,
        [("n4-card0", 4, "affinity", True, ["cuda:0"]), ("n4-cards", 4, "affinity", True, devices),
         ("n4-cards-lockstep", 4, "affinity", False, devices)], f"{cards} cards fleet")
    engines = [fleet.engine(n) for fleet in fleets.values() for n in fleet.replicas]
    for eng in engines:
        where = {str(t.device) for t in (eng.params["layers"]["wqkv"], *eng._pool.values())}
        if where != {str(eng.device)}:
            raise AssertionError(f"replica {eng.name} on {eng.device} holds tensors on {where}")
    one_card = drive["passes"]["n4-card0"]
    check_fleet_tokens(torch, {"passes": {tag: drive["passes"][tag]
                                          for tag in ("n4-cards", "n4-cards-lockstep")}},
                       lambda tag, rnd: dict(enumerate(one_card[rnd]["reqs"])), logits_at,
                       f"{cards} cards fleet vs card 0")
    numbers = {tag: fleet_numbers(fleets[tag], drive["passes"][tag]) for tag in fleets}
    for tag, num in numbers.items():
        log(f"{cards} cards, fleet {tag}: {fleet_line(num)}; placements {num['routed']}")
    log(f"{cards} cards fleet: 4 replicas on 4 cards {numbers['n4-cards']['tokens_per_s']:.3f} "
        f"tokens/s against 4 on one card {numbers['n4-card0']['tokens_per_s']:.3f} "
        f"({numbers['n4-cards']['tokens_per_s'] / numbers['n4-card0']['tokens_per_s']:.4f}x), "
        f"ticked in one thread {numbers['n4-cards-lockstep']['tokens_per_s']:.3f}; "
        f"allocated by card {[torch.cuda.memory_allocated(d) for d in devices]} bytes")
    for fleet in fleets.values():
        fleet.close()
    return {"launches": launches, **numbers}


# -- rows and MoE -------------------------------------------------------------
ROUTER_TIE = 1e-5  # top-2 router probabilities this close may route either way


def moe_walk(torch, burnin, decode, moe, params, cfg, kv_int8=False):
    """``walk(prompt, generated) -> (row, margin)``: the logits that pick
    the token after ``prompt + generated`` along a generation's own path
    (the prompt's B=1 prefill, then one-token steps: for an MoE model a
    forward over the whole sequence routes with another capacity), and
    the smallest top-2 router probability margin on the way."""
    def walk(prompt, generated):
        margins = []
        real = burnin.moe_mlp

        def recording(layer, h, config, capacity=None):
            top2 = torch.topk(moe.route(layer, h), 2, dim=-1).values
            margins.append((top2[..., 0] - top2[..., 1]).min())
            return real(layer, h, config, capacity)

        burnin.moe_mlp = recording
        try:
            with torch.no_grad():
                cache = decode.init_cache(cfg, 1, kv_int8, device="cuda")
                toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
                logits, cache = decode.decode_forward(params, toks, cache, 0, cfg)
                for j, t in enumerate(generated):
                    tok = torch.tensor([[t]], dtype=torch.int32, device="cuda")
                    logits, cache = decode.decode_forward(params, tok, cache, len(prompt) + j, cfg)
        finally:
            burnin.moe_mlp = real
        return logits[0, -1], min(m.item() for m in margins)

    return walk


def check_against_oracle(torch, done, oracle, walk, label):
    """Per request, the engine's tokens equal the oracle's (its B=1
    generation) up to the first divergence, which must be a near-tie
    along the oracle's path: its logits' top-2 margin within 2 bf16 ulps
    of the row's largest logit, or a routing on the way whose top-2
    router probabilities lie within ``ROUTER_TIE``."""
    diverged = 0
    for rid, r in done.items():
        a, b = r.tokens, oracle[rid]
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        if len(a) != len(b):
            raise AssertionError(f"{label}, request {rid}: {len(a)} tokens, oracle {len(b)}")
        if i is None:
            continue
        diverged += 1
        row, router = walk(r.prompt, b[:i])
        top2 = torch.topk(row, 2).values
        margin = (top2[0] - top2[1]).item()
        tol = 2 ** -6 * row.abs().max().item()
        log(f"{label}, request {rid}: tokens differ first at {i} ({a[i]} vs {b[i]}); logit margin "
            f"{margin} (near-tie tolerance {tol}), smallest router margin {router}")
        if margin > tol and router > ROUTER_TIE:
            raise AssertionError(f"{label}, request {rid}: tokens differ at {i}, no near-tie")
    log(f"{label}: {len(done) - diverged} of {len(done)} requests token-identical to their B=1 "
        f"generation, {diverged} first differ at a near-tie")


def oracle_tokens(decode, params, cfg, stream, kv_int8=False):
    """Each request's B=1 greedy generation (`decode.make_generate`: the
    unpadded prefill, then dropless one-token steps), by request id."""
    import torch

    out = {}
    for rid, (prompt, budget) in enumerate(stream):
        fn = decode.make_generate(cfg, prompt_len=len(prompt), steps=budget, kv_int8=kv_int8)
        toks = fn(params, torch.tensor([prompt], dtype=torch.int32, device="cuda"))
        out[rid] = toks[0, len(prompt):].tolist()
    return out


def serve_rows(ServeEngine, pa, params, cfg, stream, label, warm_up=False, before=None,
               **engine_kw):
    """The stream through a rows engine (`serve`; ``before(engine)`` runs
    ahead of the submissions), K1's launches counted from 0 and held at
    0 (the rows layout has no block table); the admission waves counted.
    Returns the engine, the finished requests, the wall, the step walls,
    the host-sync text and the waves."""
    box = {}

    def hooks(eng):
        if before is not None:
            before(eng)
        box["waves"] = count_waves([eng])
        box["walls"] = timed_steps(eng)

    pa.paged_attention.launches = 0
    eng, done, wall, _, synced = serve(ServeEngine, params, cfg, stream, "gather",
                                       warm_up=warm_up, before=hooks, kv_layout="rows",
                                       **engine_kw)
    if pa.paged_attention.launches:
        raise AssertionError(f"{label}: {pa.paged_attention.launches} K1 launches on rows")
    if eng.kv_layout != "rows":
        raise AssertionError(f"{label}: layout {eng.kv_layout}")
    for r in done.values():
        if r.finish_reason != "budget" or not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"{label}, request {r.id}: {r.finish_reason}")
    return eng, done, wall, box["walls"], synced, box["waves"][0]


def check_schedule(eng, waves, label, run):
    counts = (waves, eng.device_steps, eng.wasted_steps, device_calls(eng))
    if counts != ROWS_SCHEDULE[run]:
        raise AssertionError(f"{label}: (waves, steps, wasted, calls) {counts}, the CPU schedule "
                             f"test pins {ROWS_SCHEDULE[run]}")
    return counts


MOE_PROFILE_LABELS = {  # torch.einsum equations of the MoE decode step, by part
    "bsec,bsd->ebcd": "dispatch/combine", "bsec,ebcd->bsd": "dispatch/combine",
    "ebcd,edf->ebcf": "expert GEMMs", "ebcf,efd->ebcd": "expert GEMMs",
}


def profile_moe_decode(torch, serve_mod, burnin, decode, moe, params, cfg, steps: int = 8):
    """Where an MoE decode step's device time goes: 8 rows mid-decode
    (contexts 256..480) on rows, ``steps`` steps under torch.profiler with
    the step's parts marked (`torch.profiler.record_function`): the
    router, the expert GEMMs, the rest of the expert MLP (the dispatch
    and combine: their tensors and products), the attention over the
    rows, and everything else.  Each kernel goes to the innermost part
    whose host range holds its launch.  Returns ms a step by part."""
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = serve_mod.ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                                kv_layout="rows")
    for i in range(8):
        eng.submit([(7 * i + j) % cfg.vocab for j in range(256 + 32 * i)], 64)
    eng.tick()
    eng.tick()
    torch.cuda.synchronize()

    def marked(label, fn):
        def run(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return run

    real_einsum, real_route = torch.einsum, moe.route
    real_moe, real_attend = burnin.moe_mlp, decode._attend_dense

    def einsum(eq, *ops):
        label = MOE_PROFILE_LABELS.get(eq)
        if label is None:
            return real_einsum(eq, *ops)
        with record_function(label):
            return real_einsum(eq, *ops)

    torch.einsum, moe.route = einsum, marked("router", real_route)
    burnin.moe_mlp, decode._attend_dense = marked("moe", real_moe), marked("attention",
                                                                            real_attend)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.tick()
            torch.cuda.synchronize()
    finally:
        torch.einsum, moe.route = real_einsum, real_route
        burnin.moe_mlp, decode._attend_dense = real_moe, real_attend
    eng.close()
    report_profile(prof, "chip_smoke_decode_moe_rows_trace.json",
                   f"{steps} MoE decode steps of 8 rows on rows", steps)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "chip_smoke_decode_moe_rows_trace.json"), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"] in {"router", "moe", "attention", "dispatch/combine",
                                      "expert GEMMs"})
    parts = dict.fromkeys(("router", "dispatch/combine", "expert GEMMs", "attention", "rest"), 0.0)
    for k in (e for e in events if e.get("cat") == "kernel"):
        t = launch_at.get(k.get("args", {}).get("correlation"))
        inside = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        label = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "rest"
        parts["dispatch/combine" if label == "moe" else label] += float(k["dur"]) / 1e3 / steps
    total = sum(parts.values())
    if not total:
        log("MoE decode step by part: not measured (the trace holds no kernels)")
        return None
    log("MoE decode step by part (kernel time a step): " + "; ".join(
        f"{p} {ms:.4f} ms ({ms / total:.4f})" for p, ms in parts.items()) + f"; total {total:.4f} ms")
    return parts


def phase_rows_moe(torch, cfg_mod, serve_mod, decode, moe, prng, weights, quant, pa,
                   paged_done, paged_line):
    """The MoE family and the rows layout at the serving width: (a) MoE
    greedy on rows against each request's B=1 generation, with a decode
    profile by part; (b) the same with int8 weights and an int8 row
    cache; (c) sampled, continuous and fused ticks of 4; (d) the dense
    model on rows against the paged kernel engine; (e) the rows prefix
    cache, and a warm restart from its index.  Every rows path holds K1
    at 0 launches.  Returns those paths' launches."""
    launches = {}
    cfg = cfg_mod.BurninConfig(**SERVE_WIDTH, **MOE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = cfg_mod.init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in cfg_mod._leaves(full))
    params = weights.cast_matrices(full)
    qparams = quant.quantize_params(full)
    del full
    torch.cuda.empty_cache()
    if (params["layers"]["router"].dtype != torch.float32
            or qparams["layers"]["router"].dtype != torch.float32
            or not quant.is_quantized_leaf(qparams["layers"]["w1e"])):
        raise AssertionError("MoE weights: the router must stay f32, the experts be quantized")
    stream = make_stream(cfg.vocab)
    log(f"MoE config: {cfg.moe_experts} experts, capacity factor {cfg.moe_capacity} (prefill "
        f"queues of {min(512, moe.expert_capacity(cfg))} tokens, decode dropless), {n_params} "
        f"params; weight bytes bf16 {quant.tree_bytes(params)} (embed f32), int8 "
        f"{quant.tree_bytes(qparams)}")

    # (a) Greedy, bf16, against each request's B=1 generation.
    serve_rows(serve_mod.ServeEngine, pa, params, cfg, stream[:2], "warm-up",
               warm_up=True)[0].close()
    eng, done, wall, walls, synced, waves = serve_rows(serve_mod.ServeEngine, pa, params, cfg,
                                                       stream, "rows MoE")
    counts = check_schedule(eng, waves, "rows MoE", "moe greedy")
    cache_bytes = quant.tree_bytes(eng._cache)
    eng.close()
    launches["rows moe"] = 0
    log(f"rows MoE bf16: {len(done)} requests, waves/steps/wasted/calls {counts}, 0 K1 "
        f"launches; {serving_line(done, wall, walls)}; row cache bytes {cache_bytes}; {synced}")
    t = time.perf_counter()
    check_against_oracle(torch, done, oracle_tokens(decode, params, cfg, stream),
                         moe_walk(torch, cfg_mod, decode, moe, params, cfg), "rows MoE bf16")
    log(f"rows MoE bf16: B=1 oracle and its check {time.perf_counter() - t:.3f} s")
    profile_moe_decode(torch, serve_mod, cfg_mod, decode, moe, params, cfg)

    # (b) Int8 weights (the router f32) and an int8 row cache.
    serve_rows(serve_mod.ServeEngine, pa, qparams, cfg, stream[:2], "warm-up", warm_up=True,
               kv_int8=True)[0].close()
    eng, q_done, wall, walls, synced, waves = serve_rows(serve_mod.ServeEngine, pa, qparams, cfg,
                                                         stream, "rows MoE int8", kv_int8=True)
    counts = check_schedule(eng, waves, "rows MoE int8", "moe greedy")
    q_cache_bytes = quant.tree_bytes(eng._cache)
    eng.close()
    launches["rows moe int8"] = 0
    log(f"rows MoE int8: waves/steps/wasted/calls {counts}, 0 K1 launches; "
        f"{serving_line(q_done, wall, walls)}; row cache bytes {q_cache_bytes}; {synced}")
    check_against_oracle(torch, q_done, oracle_tokens(decode, qparams, cfg, stream, kv_int8=True),
                         moe_walk(torch, cfg_mod, decode, moe, qparams, cfg, kv_int8=True),
                         "rows MoE int8")
    del qparams
    torch.cuda.empty_cache()

    # (c) Sampled, continuous and fused ticks of 4, each pick recorded.
    runs, tables = {}, {}
    for run in ("moe sampled", "moe sampled tick"):
        kw, picks = ROWS_RUNS[run], []
        eng, s_done, wall, walls, synced, waves = serve_rows(
            serve_mod.ServeEngine, pa, params, cfg, stream, f"rows {run}",
            before=lambda e, picks=picks: record_picks(e, picks), **kw)
        counts = check_schedule(eng, waves, f"rows {run}", run)
        fused = kw["steps_per_tick"] if kw.get("scheduling") == "tick" else 1
        log(f"rows {run}: waves/steps/wasted/calls {counts}, 0 K1 launches; "
            f"{serving_line(s_done, wall, [w / fused for w in walls])}; {synced}")
        eng.close()
        runs[run], tables[run] = s_done, pick_table(picks)
        launches[f"rows {run}"] = 0
    equal = check_sampled_runs(torch, prng, decode, runs["moe sampled"], runs["moe sampled tick"],
                               stream, (tables["moe sampled"], tables["moe sampled tick"]),
                               "rows MoE sampled tick vs continuous")
    err = check_logprobs(torch, decode, runs["moe sampled"], stream, tables["moe sampled"])
    log(f"rows MoE sampled, tick vs continuous: {equal} of {len(stream)} requests equal "
        f"throughout; logprobs vs log_softmax of the pick's logits: max abs err {err}")
    del runs, tables, params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) The dense model on rows against the paged kernel engine.
    dcfg = cfg_mod.BurninConfig(**SERVE_WIDTH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dparams = weights.cast_matrices(cfg_mod.init_params(dcfg, gen, device="cuda"))
    eng, d_done, wall, walls, synced, waves = serve_rows(serve_mod.ServeEngine, pa, dparams, dcfg,
                                                         stream, "rows dense")
    counts = check_schedule(eng, waves, "rows dense", "moe greedy")
    eng.close()
    launches["rows dense"] = 0
    log(f"rows dense: waves/steps/wasted/calls {counts}, 0 K1 launches; "
        f"{serving_line(d_done, wall, walls)}; {synced}")
    log(f"paged dense through K1 (phase engine): {paged_line}")
    logits_at = dense_logits_at(cfg_mod, dparams, dcfg)
    check_near_ties(torch, d_done, paged_done, logits_at, "dense rows vs paged K1")

    # (e) The rows prefix cache, then a warm restart from its index.
    pstream = prefix_stream(dcfg.vocab)
    eng, on, on_wall, on_walls, synced, _ = serve_rows(serve_mod.ServeEngine, pa, dparams, dcfg,
                                                       pstream, "rows prefix",
                                                       prefix_cache_slots=8)
    reused = [on[i].prefix_reused for i in sorted(on, key=lambda i: on[i].admitted_at)]
    pf, index = eng.prefix_stats, eng.export_prefix_index()
    eng.close()
    if reused != [0] + [384] * 15:
        raise AssertionError(f"rows prefix: reuse in admission order {reused}")
    _, off, off_wall, off_walls, _, _ = serve_rows(serve_mod.ServeEngine, pa, dparams, dcfg,
                                                   pstream, "rows prefix off")
    launches["rows prefix"] = 0
    log(f"rows prefix cache: 384 tokens reused on 15 of 16 requests (the first admission "
        f"missed), prefill tokens computed {pf['prefill_tokens_computed']}, reused "
        f"{pf['prefill_tokens_reused']}, hits {pf['hits']}; cache on "
        f"{serving_line(on, on_wall, on_walls)}; cache off {serving_line(off, off_wall, off_walls)}"
        f"; {synced}")
    check_near_ties(torch, on, off, logits_at, "rows prefix cache on vs off")
    warmed = []
    eng, warm, _, _, synced, _ = serve_rows(
        serve_mod.ServeEngine, pa, dparams, dcfg, pstream, "rows warm restart",
        before=lambda e: warmed.append(e.warm_start(index)), prefix_cache_slots=8)
    eng.close()
    reused = [warm[i].prefix_reused for i in sorted(warm, key=lambda i: warm[i].admitted_at)]
    if warmed != [len(index["entries"])] or reused != [384] * 16:
        raise AssertionError(f"rows warm restart: {warmed} of {len(index['entries'])} runs "
                             f"warmed, reuse in admission order {reused}")
    launches["rows warm restart"] = 0
    log(f"rows warm restart: {warmed[0]} runs warmed; 384 tokens reused on 16 of 16 requests "
        f"from the first admission; {synced}")
    check_near_ties(torch, warm, on, logits_at, "rows warm restart vs cold")
    return launches


def phase_moe_train(torch, burnin, models, steps: int = 3):
    """`train_family("moe")` at the serving width cut to 2 layers (batch
    16, seq 1024): the loss finite and descending; the load-balance term
    at the initial weights (the seeded ones `train` starts from)."""
    width = dict(SERVE_WIDTH, n_layers=2)
    cfg = models.family_config("moe", **width)
    with torch.no_grad():
        params = burnin.init_params(cfg, device="cuda")
        n_params = sum(t.numel() for t in burnin._leaves(params))
        _, aux = burnin.forward(params, burnin.prepare_tokens(cfg, "cuda"), cfg, return_aux=True)
        aux = aux.item()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    report = models.train_family("moe", steps=steps, device="cuda", **width)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not report.ok or report.steps != steps or not math.isfinite(report.loss_last):
        raise AssertionError(f"moe train: {report}")
    log(f"train moe (2 layers, {cfg.moe_experts} experts, {n_params} params): {report.steps} "
        f"steps, loss {report.loss_first:.6f} -> {report.loss_last:.6f}, load-balance term at the "
        f"initial weights {aux:.6f} (x {cfg.moe_aux_weight} in the loss), step p50 "
        f"{report.step_seconds_p50 * 1e3:.3f} ms, {report.tokens_per_second:.3f} tokens/s, peak "
        f"memory allocated {peak_gb:.3f} GB")


def phase_families(models):
    """`serve_family` at each family's preset: the single-device families
    (bf16, and moe int8) serve healthy generations; the context-parallel
    and pipelined families report the config's refusal, not raise."""
    lines = []
    for name, int8, want_ok in (("dense", False, True), ("flash", False, True),
                                ("rope", False, True), ("moe", False, True), ("moe", True, True),
                                ("long_context", False, False), ("long_context_a2a", False, False),
                                ("long_context_moe", False, False), ("pipelined", False, False)):
        report = models.serve_family(name, int8=int8, device="cuda")
        if report.ok != want_ok or (not want_ok and not report.error.startswith("ValueError")):
            raise AssertionError(f"serve_family({name!r}, int8={int8}): {report}")
        lines.append(f"{name}{' int8' if int8 else ''} "
                     + (f"ok, {report.tokens_per_second} tokens/s, {report.request_ms} ms"
                        if report.ok else f"refused ({report.error[:60]}...)"))
    log("serve_family: " + "; ".join(lines))


@contextlib.contextmanager
def recorded_losses(burnin):
    """Every loss the steps ``burnin.make_train_step`` builds return while
    the context is open, in a list (as tensors; `burnin.train` looks the
    factory up at each call).  ``burnin`` may be any module that calls the
    factory by that name (`data`, `ckpt`)."""
    real = burnin.make_train_step
    losses = []

    def recording(*args, **kwargs):
        step, state = real(*args, **kwargs)

        def step_and_record(state, tokens):
            state, loss = step(state, tokens)
            losses.append(loss)
            return state, loss

        return step_and_record, state

    burnin.make_train_step = recording
    try:
        yield losses
    finally:
        burnin.make_train_step = real


def phase_train(torch, burnin, mfu, fa, flash, steps: int = 6):
    """Single-device training of the flash family at full width: the
    width `chip_sized_config` gives an 80 GB card, params from init_params'
    seeded generator, momentum at the config's lr.  Returns the kernel's
    launches in the ``train`` run, its step p50 in seconds, its losses
    and its peak memory in GB."""
    cfg = dataclasses.replace(mfu.chip_sized_config(80), flash_attention=True)
    log(f"train config: vocab {cfg.vocab}, d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff "
        f"{cfg.d_ff}, {cfg.n_layers} layers, seq {cfg.seq}, batch {cfg.batch}, "
        f"{mfu.param_count(cfg)} params, {cfg.optimizer} lr {cfg.learning_rate}")
    # The serving phases' engines hold the serving weights in reference
    # cycles (their wrapped methods); collect them before the peak counts.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_forward.launches = 0  # count only the main path's launches
    with recorded_losses(burnin) as losses:
        report = burnin.train(cfg, steps=steps, device="cuda")
    launches = fa.flash_attention_forward.launches
    losses = [float(l) for l in losses]
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
    return launches, report.step_seconds_p50, losses, peak_gb


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


# The tp sizes at which K2 runs rank by rank over head slices.
SHARDED_MODELS = (2, 4, 8)


def rank_heads(qkv, model: int, rank: int):
    """One tp rank's q, k and v at ``model`` ranks: its heads of a
    (b, s, 3, h, d) qkv product, contiguous as the rank's own
    column-parallel product leaves them, viewed as q, k and v."""
    n = qkv.shape[3] // model
    local = qkv[:, :, :, rank * n:(rank + 1) * n].contiguous()
    return local[:, :, 0], local[:, :, 1], local[:, :, 2]


def sharded_kernel(torch, fa, flash):
    """K2 through `flash_attention_sharded` rank by rank at the trainer's
    shape: at each tp size, one launch a rank on its heads; the launches
    counted, their outputs concatenated bitwise equal to one launch over
    every head, and within `FLASH_BF16_TOL` of the plain version.  One
    rank's launch at tp 2 timed beside its bound, its plain version and
    `scaled_dot_product_attention` on the same heads.  Returns the
    kernel's JSON row."""
    b, s, h, d = 16, 1024, 32, 128
    g = torch.Generator(device="cuda").manual_seed(31)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        whole = fa.flash_attention_forward(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True, 128, 128)
        plain = fa.flash_attention_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True, 128,
                                         128).float()
        err = 0.0
        for model in SHARDED_MODELS:
            fa.flash_attention_forward.launches = 0
            parts = [flash.flash_attention_sharded(*rank_heads(qkv, model, r), {"model": model},
                                                   "model", block_q=128, block_k=128)
                     for r in range(model)]
            launches = fa.flash_attention_forward.launches
            got = torch.cat(parts, dim=2)
            if launches != model:
                raise AssertionError(f"tp {model}: {launches} K2 launches, want {model}")
            if not torch.equal(got, whole):
                raise AssertionError(f"tp {model}: the ranks' heads differ from one launch "
                                     "over every head")
            err = max(err, (got.float() - plain).abs().max().item())
            if not torch.allclose(got.float(), plain, **FLASH_BF16_TOL):
                raise AssertionError(f"tp {model}: vs plain max abs err {err}")
        log(f"K2 rank by rank at ({b}, {s}, {h}, {d}) bf16 causal, tp {SHARDED_MODELS}: one "
            f"launch a rank each, the ranks' heads concatenated bitwise equal to one launch over "
            f"every head; max abs err {err} vs plain (tol {FLASH_BF16_TOL})")
        del whole, plain, parts, got
        q, k, v = rank_heads(qkv, 2, 0)
        scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
        flush = scrub.zero_
        rank_ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, True, 128, 128), flush)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True, 128, 128), flush,
                           n=20, warmup=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
    bound_ms, bound_by = flash_bound_ms(q, True)
    log(f"K2 one rank at tp 2 ({b}, {s}, {h // 2}, {d}): kernel {rank_ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, scaled_dot_product_attention {library_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return {
        "name": "flash_attention_sharded",
        "route": "cuda",
        "source": "tpu_dra_torch/parallel/kernels/csrc/flash_attn.cu",
        "replaces": "tpu_dra/parallel/flash.py:185",
        "launches": None,
        "max_abs_err": err,
        "ms": rank_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _rank_run(torch, burnin, moe, fa, pa, run: dict, world: int, on_card: bool) -> dict:
    """One training run of a rank: ``run["config"]`` over its mesh of
    every rank (`burnin.burnin_mesh`, or `moe.moe_mesh` with
    ``run["moe_mesh"]``'s axes) for ``run["steps"]`` steps through
    `burnin.train`, K1's and K2's launches counted from 0."""
    ranks = range(world)
    mesh = (moe.moe_mesh(ranks, **run["moe_mesh"]) if run.get("moe_mesh")
            else burnin.burnin_mesh(ranks))
    cfg = burnin.BurninConfig(**run["config"])
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_forward.launches = 0
    pa.paged_attention.launches = 0
    with recorded_losses(burnin) as losses:
        report = burnin.train(cfg, mesh, steps=run["steps"])
    return {"report": dataclasses.asdict(report), "losses": [float(l) for l in losses],
            "launches": fa.flash_attention_forward.launches,
            "k1_launches": pa.paged_attention.launches,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0}


def _sharded_rank(rank: int, init_method: str, plan: dict, out) -> None:
    """Rank ``rank`` of a group of ``plan["world"]`` (NCCL, a card a rank;
    gloo on the CPU) training ``plan["config"]`` sharded over
    `burnin.burnin_mesh` of every rank for ``plan["steps"]`` steps through
    `burnin.train`, K2's launches counted; then each run of
    ``plan["also"]`` (`_rank_run`); with ``plan["families"]``, the
    long-context and MoE families over the same mesh at their preset
    width for 2 steps, K1's launches counted; with ``plan["bound"]``,
    `moe.routing_temp_comparison` on `moe.moe_mesh` (model 2, expert 2)
    of every rank.  Puts ``(rank, result)`` on ``out``.  Runs in a
    spawned process."""
    try:
        import torch

        from tpu_dra_torch import models
        from tpu_dra_torch.parallel import burnin, gang, moe
        from tpu_dra_torch.parallel.kernels import flash_attn as fa
        from tpu_dra_torch.parallel.kernels import paged_attn as pa

        # As in the main process: the single-device run this is held to
        # ran with these off.
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        on_card = plan["device"] == "cuda"
        world = plan["world"]
        gang.join_group(init_method, world_size=world, rank=rank,
                        device=f"cuda:{rank}" if on_card else "cpu", timeout_s=300)
        result = _rank_run(torch, burnin, moe, fa, pa,
                           {"config": plan["config"], "steps": plan["steps"]}, world, on_card)
        result["also"] = [_rank_run(torch, burnin, moe, fa, pa, run, world, on_card)
                          for run in plan["also"]]
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        if plan["families"]:
            mesh = burnin.burnin_mesh(range(world))
            pa.paged_attention.launches = 0
            result["families"] = {
                name: dataclasses.asdict(models.train_family(name, mesh, steps=2))
                for name in ("long_context", "moe")}
            result["families_k1_launches"] = pa.paged_attention.launches
        if plan["bound"]:
            result["bound"] = moe.routing_temp_comparison(
                moe.moe_mesh(range(world), model=2, expert=2))
        out.put((rank, result))
    except Exception:
        out.put((rank, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_sharded_ranks(validate, config, steps: int, world: int = 1, device: str = "cuda",
                      families: bool = True, also=(), bound: bool = False,
                      timeout: float = 600):
    """`_sharded_rank` in ``world`` spawned workers (``also``: further
    runs, each ``{"config": BurninConfig, "steps": N}`` and optionally
    ``"moe_mesh": {axis: size}``); their results by rank, or raise with
    the first failure's traceback.  Every worker is stopped before this
    returns."""
    plan = {"config": dataclasses.asdict(config), "steps": steps, "device": device,
            "world": world, "families": families, "bound": bound,
            "also": [dict(run, config=dataclasses.asdict(run["config"])) for run in also]}
    return run_ranks(validate, _sharded_rank, plan, world, timeout, "sharded training")


def run_ranks(validate, target, plan: dict, world: int, timeout: float, what: str):
    """``target(rank, init_method, plan, out)`` in ``world`` spawned
    workers; their results by rank, or raise with the first failure's
    traceback.  Every worker is stopped before this returns."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init = f"tcp://127.0.0.1:{validate._free_port()}"
    workers = [ctx.Process(target=target, args=(r, init, plan, out), daemon=True)
               for r in range(world)]
    for w in workers:
        w.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < world and time.monotonic() < deadline:
            try:
                rank, res = out.get(timeout=1.0)
            except queue.Empty:
                if any(w.exitcode is not None and r not in got for r, w in enumerate(workers)):
                    break  # a worker died without a result
                continue
            got[rank] = res
            if isinstance(res, str):
                break
    finally:
        for w in workers:
            w.join(timeout=60)
            if w.is_alive():
                w.kill()
                w.join()
    failed = {r: res for r, res in got.items() if isinstance(res, str)}
    if failed or len(got) < world:
        missing = sorted(set(range(world)) - set(got))
        raise AssertionError(f"{what} workers failed: {failed}; no result from {missing}")
    return [got[r] for r in range(world)]


def held_to(losses, single_losses, label: str) -> str:
    """How ``losses`` stand to the one-device run's on the same weights:
    bitwise, or within `FIRST_LOSS_RTOL` (the gap returned); else raise."""
    if losses == single_losses:
        return "bitwise equal to"
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, single_losses))
    if len(losses) != len(single_losses) or gap > FIRST_LOSS_RTOL:
        raise AssertionError(f"{label} losses {losses} vs one device {single_losses}: "
                             f"rel gap {gap} > {FIRST_LOSS_RTOL}")
    return f"within a relative gap of {gap:.3e} (tol {FIRST_LOSS_RTOL}) of"


def check_run(got, cfg, steps: int, label: str, k2: "int | None" = None) -> None:
    """A run's report ok over ``steps`` steps, the loss descending, K1
    never launched and K2 launched ``k2`` times (default: steps x 2 x
    layers, a forward and the checkpoint's recompute a layer)."""
    report = got["report"]
    if not report["ok"] or report["error"] or report["steps"] != steps:
        raise AssertionError(f"{label}: {report}")
    want = steps * 2 * cfg.n_layers if k2 is None else k2
    if got["launches"] != want or got["k1_launches"]:
        raise AssertionError(f"{label}: {got['launches']} K2 launches (want {want}), "
                             f"{got['k1_launches']} K1 launches (want 0)")


def check_sharded_run(got, cfg, steps: int, single_losses, single_p50: float) -> str:
    """The sharded run against the contract: ok, K2 launched steps x 2 x
    layers, the losses those of the single-device run on the same weights
    (bitwise, or within `FIRST_LOSS_RTOL`, the gap printed), the two
    families ok with K1 never launched.  Returns the run's line."""
    report, losses = got["report"], got["losses"]
    check_run(got, cfg, steps, "sharded train")
    how = held_to(losses, single_losses, "sharded")
    for name, fam in got["families"].items():
        if not fam["ok"] or fam["steps"] != 2 or not fam["loss_last"] < fam["loss_first"]:
            raise AssertionError(f"train_family({name!r}, mesh): {fam}")
    if got["families_k1_launches"]:
        raise AssertionError(f"K1 launched {got['families_k1_launches']} times in the families' "
                             "training")
    fams = "; ".join(f"{name} loss {f['loss_first']:.6f} -> {f['loss_last']:.6f}, step p50 "
                     f"{f['step_seconds_p50'] * 1e3:.3f} ms" for name, f in got["families"].items())
    return (f"{report['steps']} steps, losses {losses} {how} the one-device run's; step p50 "
            f"{report['step_seconds_p50'] * 1e3:.3f} ms against burnin.train's "
            f"{single_p50 * 1e3:.3f} ms; {got['launches']} K2 launches; peak memory allocated "
            f"{got['peak_gb']:.3f} GB; families on the same mesh: {fams}; 0 K1 launches")


def phase_sharded(torch, fa, flash, mfu, validate, single_losses, single_p50: float, steps: int = 6):
    """Sharded training: K2 rank by rank (`sharded_kernel`), then the
    flash family at the trainer's width sharded over a one-rank NCCL mesh
    in a spawned worker, held to phase 10's one-device run, and the
    long-context and MoE families on that mesh.  Returns K2's sharded
    row and the sharded run's launches."""
    row = sharded_kernel(torch, fa, flash)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(mfu.chip_sized_config(80), flash_attention=True)
    got = run_sharded_ranks(validate, cfg, steps)[0]
    log("sharded train (flash, full width, burnin_mesh([0]) over NCCL): "
        + check_sharded_run(got, cfg, steps, single_losses, single_p50))
    row["launches"] = got["launches"]
    return row, got["launches"]


# -- sharded serving ---------------------------------------------------------


def serving_numbers(done, wall, step_walls) -> dict:
    """The engine's end-to-end numbers: tokens/s, TTFT p50 and decode-step
    p50 (host clocks, seconds)."""
    return {"tokens_per_s": sum(len(r.tokens) for r in done.values()) / wall,
            "ttft_p50_s": statistics.median(r.ttft_s for r in done.values()),
            "step_p50_s": statistics.median(step_walls)}


def _launches(pa, fa):
    return {"k1": pa.paged_attention.launches, "k2": fa.flash_attention_forward.launches}


def _zero_launches(pa, fa):
    pa.paged_attention.launches = 0
    fa.flash_attention_forward.launches = 0


def _mesh_engine_run(ServeEngine, quant, pa, fa, params, cfg, stream, mesh, form, **engine_kw):
    """The stream through one engine on ``mesh`` (None: one device) after
    a two-request warm-up, K1's and K2's launches counted from 0 just
    before and read just after, held to the host-sync contract.  Returns
    its tokens by request, numbers, bytes and launches."""
    kv_int8 = form == "int8"
    kw = dict(engine_kw, mesh=mesh) if mesh is not None else engine_kw
    serve(ServeEngine, params, cfg, stream[:2], "gather", kv_int8, warm_up=True, **kw)[0].close()
    _zero_launches(pa, fa)
    eng, done, wall, steps, synced = serve(ServeEngine, params, cfg, stream, "gather", kv_int8,
                                           **kw)
    run = {"tokens": {rid: list(r.tokens) for rid, r in done.items()},
           "numbers": serving_numbers(done, wall, steps), "synced": synced,
           "steps": eng.device_steps, "weight_bytes": quant.tree_bytes(params),
           "pool_bytes": quant.tree_bytes(eng._pool if eng.kv_layout == "paged" else eng._cache),
           **_launches(pa, fa)}
    eng.close()
    return run


def _serve_rank(rank: int, init_method: str, plan: dict, out) -> None:
    """Rank ``rank`` of a group of ``plan["world"]`` (NCCL, a card a rank)
    serving the main stream at full width over `burnin.burnin_mesh` of
    every rank (`_mesh_serving`).  Puts ``(rank, result)`` on ``out``.
    Runs in a spawned process."""
    try:
        import torch

        from tpu_dra_torch import models
        from tpu_dra_torch.parallel import burnin, decode, disagg, gang, quant, weights
        from tpu_dra_torch.parallel.kernels import flash_attn as fa
        from tpu_dra_torch.parallel.kernels import paged_attn as pa
        from tpu_dra_torch.parallel.serve import ServeEngine

        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        world = plan["world"]
        gang.join_group(init_method, world_size=world, rank=rank, device=f"cuda:{rank}",
                        timeout_s=300)
        mesh = burnin.burnin_mesh(range(world))
        out.put((rank, _mesh_serving(torch, models, burnin, decode, disagg, quant, weights,
                                     ServeEngine, fa, pa, mesh, plan["one_card"])))
    except Exception:
        out.put((rank, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


DISAGG_INT_FIELDS = ("occupancy", "slots", "queue_depth", "admitted", "prefix_hits", "finished",
                     "tokens", "preempted", "swapped_in", "slo_met", "slo_missed")


def _mesh_disagg(torch, disagg, pa, fa, params, cfg, stream, mesh) -> dict:
    """The main stream through `DisaggServer` with both tiers on ``mesh``
    (None: one device), phase 8's tier shapes through the gather (the
    kernel serves one device only), alias then dma: blocks conserved
    after every tick, host syncs as the contract gives them, K1's and
    K2's launches counted from 0 just before and read just after.
    Returns each mode's tokens, both tiers' step records (their integer
    fields), launches and numbers."""
    from tpu_dra_torch.utils import servestats

    where = "one device" if mesh is None else "mesh"
    spec = dict(slots=8, prompt_slots=512, max_new_cap=64, attn_backend="gather", mesh=mesh)
    out = {}
    for mode in ("alias", "dma"):
        name = f"disagg-{mode}-{where.replace(' ', '-')}"
        srv = disagg.DisaggServer(params, cfg, prefill=dict(spec),
                                  decode=dict(spec, kv_blocks=41), handoff=mode, name=name)
        pre, dec = srv.tiers["prefill"], srv.tiers["decode"]
        dec_steps = timed_steps(dec)
        waves = count_waves([pre, dec])
        dids = [srv.submit(p, b) for p, b in stream]
        _zero_launches(pa, fa)
        t = time.perf_counter()
        with host_syncs(torch) as syncs:
            while srv.pending:
                srv.tick()
                if mode == "alias":
                    check_blocks_conserved([pre, dec], f"{where} disagg alias")
                else:
                    check_blocks_conserved([pre], f"{where} disagg dma, prefill")
                    check_blocks_conserved([dec], f"{where} disagg dma, decode")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        handed = srv.disagg_stats()["prefill"]["handoff_out_requests"]
        synced = check_host_syncs(syncs, waves[0], [pre, dec], f"{where} disagg {mode}",
                                  dma=handed if mode == "dma" else 0)
        done = {i: srv.result(d) for i, d in enumerate(dids)}
        out[mode] = {
            "tokens": {i: list(r.tokens) for i, r in done.items()},
            "records": {tier: [{f: getattr(r, f) for f in DISAGG_INT_FIELDS}
                               for r in servestats.RECORDER.query(engine=f"{name}-{tier}")]
                        for tier in ("prefill", "decode")},
            "numbers": serving_numbers(done, wall, dec_steps), "synced": synced,
            "handed": handed, "steps": dec.device_steps, **_launches(pa, fa)}
        srv.close()
    return out


def _mesh_serving(torch, models, burnin, decode, disagg, quant, weights, ServeEngine, fa, pa,
                  mesh, one_card: bool) -> dict:
    """A rank's sharded serving at full width: the phase-5 weights (the
    same seed on every rank), cut into the rank's shards
    (`weights.shard_params`, int8 quantized whole first), the main stream
    through the paged engine on ``mesh`` in bf16 and int8 (``kv_int8``),
    and through `DisaggServer` with both tiers on ``mesh`` (bf16, alias
    and dma, `_mesh_disagg`).  With ``one_card`` (a one-rank mesh) also
    the one-device gather engine and the one-device `DisaggServer` in the
    same process, the rows engine on the mesh and on one device,
    `make_generate_padded` and rope `make_generate` on the mesh and on
    one device, and `serve_family` for dense, flash and moe over the mesh
    (long_context refused).  Every path's K1 and K2 launches are counted
    from 0 just before it and read just after."""
    import numpy as np

    cfg = burnin.BurninConfig(**SERVE_WIDTH)
    stream = make_stream(cfg.vocab)
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = burnin.init_params(cfg, gen, device="cuda")
    wholes = {"bf16": weights.cast_matrices(full), "int8": quant.quantize_params(full)}
    del full
    shards = {form: weights.shard_params(w, cfg, mesh) for form, w in wholes.items()}
    if not one_card:
        del wholes
    gc.collect()
    torch.cuda.empty_cache()
    res = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}
    for form in ("bf16", "int8"):
        res[f"paged {form}"] = _mesh_engine_run(ServeEngine, quant, pa, fa, shards[form], cfg,
                                                stream, mesh, form)
        # Where the mesh step's device time goes, rank 0's: the NCCL
        # kernels (the weights' all-gathers over fsdp, the sums over
        # model) apart from the GEMMs and the rest.
        res[f"profile {form}"] = profile_decode(
            torch, ServeEngine, shards[form], cfg, kv_int8=form == "int8", backend="gather",
            form=f"mesh {'x'.join(map(str, res['mesh'].values()))} {form}",
            report=torch.distributed.get_rank() == 0,
            mesh=mesh)
    res["disagg"] = _mesh_disagg(torch, disagg, pa, fa, shards["bf16"], cfg, stream, mesh)
    if not one_card:
        return res
    res["one-device disagg"] = _mesh_disagg(torch, disagg, pa, fa, wholes["bf16"], cfg, stream,
                                            None)
    res["one-device paged bf16"] = _mesh_engine_run(ServeEngine, quant, pa, fa, wholes["bf16"],
                                                    cfg, stream, None, "bf16")
    for label, m, p in (("rows", mesh, shards["bf16"]), ("one-device rows", None,
                                                          wholes["bf16"])):
        res[label] = _mesh_engine_run(ServeEngine, quant, pa, fa, p, cfg, stream, m, "bf16",
                                      kv_layout="rows")
    # The factories: 8 of the stream's prompts, padded to 512, 16 tokens.
    prompts = torch.zeros((8, 512), dtype=torch.int32, device="cuda")
    for i, (p, _) in enumerate(stream[:8]):
        prompts[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    lens = torch.tensor([len(p) for p, _ in stream[:8]], dtype=torch.int32, device="cuda")
    rcfg = dataclasses.replace(cfg, rope=True)
    for label, c, make, args in (
            ("make_generate_padded", cfg, decode.make_generate_padded,
             dict(prompt_slots=512, steps=16)),
            ("rope make_generate", rcfg, decode.make_generate, dict(prompt_len=128, steps=16))):
        call = (prompts, lens) if label == "make_generate_padded" else (prompts[:, :128],)
        got = {}
        for where, m, p in (("mesh", mesh, shards["bf16"]), ("one device", None,
                                                              wholes["bf16"])):
            fn = make(c, m, with_health=True, **args)
            fn(p, *call)  # warm-up
            torch.cuda.synchronize()
            _zero_launches(pa, fa)
            t = time.perf_counter()
            toks, healthy = fn(p, *call)
            healthy = bool(healthy)
            got[where] = (toks.cpu().numpy(), healthy, time.perf_counter() - t,
                          _launches(pa, fa))
        res[label] = {"equal": bool(np.array_equal(got["mesh"][0], got["one device"][0])),
                      "healthy": got["mesh"][1] and got["one device"][1],
                      "shape": list(got["mesh"][0].shape),
                      "mesh_s": got["mesh"][2], "one_device_s": got["one device"][2],
                      **got["mesh"][3]}
    del wholes, shards
    gc.collect()
    torch.cuda.empty_cache()
    families = {}
    _zero_launches(pa, fa)
    for name in ("dense", "flash", "moe", "long_context"):
        families[name] = dataclasses.asdict(models.serve_family(name, mesh))
    res["serve_family"] = {"reports": families, **_launches(pa, fa)}
    return res


def check_mesh_run(run, label: str, want_tokens=None) -> str:
    """A mesh path's run: K1 and K2 never launched; its tokens bitwise
    ``want_tokens`` when given.  Returns its line."""
    if run["k1"] or run["k2"]:
        raise AssertionError(f"{label}: {run['k1']} K1 and {run['k2']} K2 launches (want 0)")
    if want_tokens is not None and run["tokens"] != want_tokens:
        diff = [rid for rid in want_tokens if run["tokens"].get(rid) != want_tokens[rid]]
        raise AssertionError(f"{label}: tokens of requests {diff} differ")
    n = run["numbers"]
    return (f"{n['tokens_per_s']:.3f} tokens/s, TTFT p50 {n['ttft_p50_s'] * 1e3:.3f} ms, "
            f"decode step p50 {n['step_p50_s'] * 1e3:.3f} ms (host clocks); {run['steps']} "
            f"steps; weights {run['weight_bytes']} B and pool {run['pool_bytes']} B a rank; "
            f"0 K1, 0 K2 launches; {run['synced']}")


def check_mesh_disagg(got, want, label: str) -> str:
    """`_mesh_disagg` runs on the mesh (``got``) against ``want`` (the
    one-device runs, or rank 0's): tokens bitwise, both tiers' step
    records' integer fields tick for tick, K1 and K2 never launched.
    Returns the lines of both modes."""
    lines = []
    for mode, run in got.items():
        if run["k1"] or run["k2"]:
            raise AssertionError(f"{label} {mode}: {run['k1']} K1, {run['k2']} K2 launches")
        if run["tokens"] != want[mode]["tokens"]:
            diff = [i for i in run["tokens"] if run["tokens"][i] != want[mode]["tokens"][i]]
            raise AssertionError(f"{label} {mode}: tokens of requests {diff} differ")
        if run["records"] != want[mode]["records"] or not run["records"]["decode"]:
            raise AssertionError(f"{label} {mode}: step records differ")
        n = run["numbers"]
        lines.append(f"{mode}: {run['handed']} handoffs, decode tier {run['steps']} steps, "
                     f"{len(run['records']['prefill'])} + {len(run['records']['decode'])} step "
                     f"records equal; {n['tokens_per_s']:.3f} tokens/s, TTFT p50 "
                     f"{n['ttft_p50_s'] * 1e3:.3f} ms, decode step p50 "
                     f"{n['step_p50_s'] * 1e3:.3f} ms; 0 K1, 0 K2; {run['synced']}")
    return "; ".join(lines)


def phase_sharded_serving(torch, validate, gather_tokens, int8_gather_tokens,
                          disagg_tokens) -> dict:
    """Sharded serving on one card: a spawned worker on a one-rank NCCL
    mesh (`burnin.burnin_mesh([0])`) at full width (`_mesh_serving`):
    the paged engine on the mesh bitwise phase 5's gather engines (bf16
    and int8), `DisaggServer` with both tiers on the mesh (alias and dma)
    bitwise the one-device gather `DisaggServer` in the same worker, its
    step records tick for tick too (phase 8's server reads KV through the
    kernel, whose tokens may leave the gather's at exact ties: how many
    are equal is logged), the rows engine, `make_generate_padded` and rope
    `make_generate` on the mesh bitwise their one-device runs, the
    serve_family probes over the mesh, K1 and K2 at 0 launches on every
    path.  Returns the mesh paths' launches by path."""
    got = run_ranks(validate, _serve_rank, {"world": 1, "one_card": True}, 1, 900,
                    "sharded serving")[0]
    mesh = got["mesh"]
    one = got["one-device paged bf16"]
    log(f"one-device paged gather engine, bf16 (the worker): {check_mesh_run(one, 'one device')}")
    for form, want in (("bf16", gather_tokens), ("int8", int8_gather_tokens)):
        line = check_mesh_run(got[f"paged {form}"], f"mesh paged {form}", want)
        log(f"mesh {mesh} paged engine {form}, tokens bitwise phase 5's {form} gather engine's: "
            f"{line}")
    line = check_mesh_disagg(got["disagg"], got["one-device disagg"], f"mesh {mesh} disagg")
    log("one-device gather DisaggServer (the worker): " + "; ".join(
        f"{mode}: {n['tokens_per_s']:.3f} tokens/s, TTFT p50 {n['ttft_p50_s'] * 1e3:.3f} ms, "
        f"decode step p50 {n['step_p50_s'] * 1e3:.3f} ms"
        for mode, n in ((m, r["numbers"]) for m, r in got["one-device disagg"].items())))
    same = {mode: sum(got["disagg"][mode]["tokens"][i] == toks for i, toks in want.items())
            for mode, want in disagg_tokens.items()}
    log(f"mesh {mesh} DisaggServer, both tiers on the mesh, tokens and step records bitwise "
        f"the one-device gather DisaggServer's: {line}; requests equal to phase 8's kernel "
        f"DisaggServer's {same} of {len(next(iter(disagg_tokens.values())))}")
    line = check_mesh_run(got["rows"], "mesh rows", got["one-device rows"]["tokens"])
    log(f"mesh {mesh} rows engine bf16, tokens bitwise the one-device rows engine's: {line}; "
        f"one-device rows: {check_mesh_run(got['one-device rows'], 'one-device rows')}")
    for label in ("make_generate_padded", "rope make_generate"):
        r = got[label]
        if not (r["equal"] and r["healthy"]) or r["k1"] or r["k2"]:
            raise AssertionError(f"{label} on the mesh: {r}")
        log(f"{label} on the mesh, {r['shape']}: bitwise its one-device run, healthy; "
            f"{r['mesh_s'] * 1e3:.3f} ms against {r['one_device_s'] * 1e3:.3f} ms on one "
            f"device; 0 K1, 0 K2 launches")
    fams = got["serve_family"]
    for name, rep in fams["reports"].items():
        want_ok = name != "long_context"
        if rep["ok"] != want_ok or (not want_ok and "context parallelism" not in rep["error"]):
            raise AssertionError(f"serve_family({name!r}, mesh): {rep}")
    if fams["k1"] or fams["k2"]:
        raise AssertionError(f"serve_family over the mesh: {fams['k1']} K1, {fams['k2']} K2")
    log("serve_family over the mesh: " + "; ".join(
        f"{n} " + (f"ok, {r['tokens_per_second']} tokens/s" if r["ok"] else "refused")
        for n, r in fams["reports"].items()) + "; 0 K1, 0 K2 launches")
    return {"mesh paged bf16": 0, "mesh paged int8": 0, "mesh disagg alias": 0,
            "mesh disagg dma": 0, "mesh rows": 0, "mesh make_generate_padded": 0,
            "mesh rope make_generate": 0, "mesh serve_family": 0}


# The Ulysses axis sizes at which K2 runs on each rank's head-swapped view.
ULYSSES_RANKS = (2, 4, 8)


def ulysses_kernel(torch, fa, flash, spmd, tp_rank_ms: float):
    """K2 on Ulysses' head-swapped view at the trainer's shape: for each
    axis size P, every rank's (b, s, 3, h / P, d) view laid out by the
    all-to-all's own packing (`spmd.all_to_all_local`, what
    `ulysses.ulysses_attention` receives), q, k and v strided views of it;
    one launch a rank through `flash.flash_attention` (Ulysses' call),
    each within `FLASH_BF16_TOL` of the plain version on the same views,
    and the ranks' outputs concatenated over heads bitwise one launch
    over every head.  One rank's launch at P = 2 timed beside its bound,
    its plain version, `scaled_dot_product_attention` on the same heads
    and ``tp_rank_ms``, the contiguous tp-2 rank's time in this run.
    Returns the numbers for K2's row."""
    b, s, h, d = 16, 1024, 32, 128
    g = torch.Generator(device="cuda").manual_seed(41)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(torch.bfloat16)
    err = 0.0
    with torch.no_grad():
        whole = fa.flash_attention_forward(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True, 128, 128)
        for p in ULYSSES_RANKS:
            views = spmd.all_to_all_local(list(qkv.chunk(p, dim=1)), 3, 1)
            fa.flash_attention_forward.launches = 0
            parts = [flash.flash_attention(v[:, :, 0], v[:, :, 1], v[:, :, 2], True, 128, 128)
                     for v in views]
            if fa.flash_attention_forward.launches != p:
                raise AssertionError(f"P {p}: {fa.flash_attention_forward.launches} K2 launches")
            for v, part in zip(views, parts):
                if v.shape != (b, s, 3, h // p, d) or not v.is_contiguous():
                    raise AssertionError(f"P {p}: swapped view {tuple(v.shape)} {v.stride()}")
                want = fa.flash_attention_plain(v[:, :, 0], v[:, :, 1], v[:, :, 2], True, 128,
                                                128).float()
                err = max(err, (part.float() - want).abs().max().item())
                if not torch.allclose(part.float(), want, **FLASH_BF16_TOL):
                    raise AssertionError(f"P {p}: K2 on the swapped view vs plain max abs err "
                                         f"{err}")
            if not torch.equal(torch.cat(parts, dim=2), whole):
                raise AssertionError(f"P {p}: the ranks' heads differ from one launch over every "
                                     "head")
            del views, parts, want
        log(f"K2 on Ulysses' head-swapped views at ({b}, {s}, {h}, {d}) bf16 causal, P "
            f"{ULYSSES_RANKS}: one launch a rank each on strided q/k/v views of a contiguous "
            f"(b, s, 3, h / P, d) swap, the ranks' heads concatenated bitwise equal to one launch "
            f"over every head; max abs err {err} vs plain (tol {FLASH_BF16_TOL})")
        del whole
        view = spmd.all_to_all_local(list(qkv.chunk(2, dim=1)), 3, 1)[0]
        del qkv
        q, k, v = view[:, :, 0], view[:, :, 1], view[:, :, 2]
        scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
        flush = scrub.zero_
        ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, True, 128, 128), flush)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True, 128, 128), flush,
                           n=20, warmup=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush)
    bound_ms, bound_by = flash_bound_ms(q, True)
    log(f"K2 one rank's swapped view at P 2 ({b}, {s}, {h // 2}, {d}), q/k/v strided views: kernel "
        f"{ms:.6f} ms (the contiguous tp-2 rank in this run: {tp_rank_ms:.6f} ms), plain "
        f"{plain_ms:.6f} ms, scaled_dot_product_attention {library_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def param_count(cfg) -> int:
    """Parameters of ``cfg``'s tree, experts included (`mfu.param_count`
    counts the dense MLP)."""
    d = cfg.d_model
    mlp = cfg.moe_experts * (d + 2 * d * cfg.d_ff) if cfg.moe_experts else 2 * d * cfg.d_ff
    return cfg.vocab * d + cfg.seq * d + d + cfg.n_layers * (4 * d * d + 2 * d + mlp)


def phase_long_context(torch, fa, flash, mfu, models, spmd, validate, single_losses,
                       single_p50: float, single_peak_gb: float, tp_rank_ms: float,
                       steps: int = 6, moe_steps: int = 3):
    """Long-context training on a mesh: K2 on Ulysses' swapped views
    (`ulysses_kernel`); then, in a spawned worker over a one-rank NCCL
    mesh, the long_context_a2a family at the trainer's width (Ulysses +
    flash) through `burnin.train(cfg, burnin_mesh([0]))` (K2 launched
    steps x 2 x layers, the losses held to phase 10's one-device run,
    where the all-to-all is the identity) and the long_context_moe family
    (ring + group-local experts) at the serving width cut to 2 layers on
    `moe_mesh([0], model=1, expert=1)` (ok, the loss descending, 0 K1 and
    0 K2 launches: the reference refuses ring + flash).  Returns the
    numbers for K2's row and the Ulysses run's launches."""
    view = ulysses_kernel(torch, fa, flash, spmd, tp_rank_ms)
    gc.collect()
    torch.cuda.empty_cache()
    a2a = dataclasses.replace(mfu.chip_sized_config(80), ulysses_attention=True,
                              flash_attention=True)
    lc_moe = models.family_config("long_context_moe", **dict(SERVE_WIDTH, n_layers=2))
    got = run_sharded_ranks(validate, a2a, steps, families=False,
                            also=[{"config": lc_moe, "steps": moe_steps,
                                   "moe_mesh": {"model": 1, "expert": 1}}])[0]
    check_run(got, a2a, steps, "long_context_a2a")
    how = held_to(got["losses"], single_losses, "long_context_a2a")
    rep = got["report"]
    log(f"long_context_a2a (Ulysses + flash, {param_count(a2a)} params, batch {a2a.batch}, "
        f"seq {a2a.seq}, {a2a.n_layers} layers) on burnin_mesh([0]) over NCCL: {rep['steps']} "
        f"steps, losses {got['losses']} {how} phase 10's one-device run; step p50 "
        f"{rep['step_seconds_p50'] * 1e3:.3f} ms against phase 10's {single_p50 * 1e3:.3f} ms; "
        f"peak memory allocated {got['peak_gb']:.3f} GB against phase 10's "
        f"{single_peak_gb:.3f} GB; {got['launches']} K2 launches; 0 K1 launches")
    moe_run = got["also"][0]
    check_run(moe_run, lc_moe, moe_steps, "long_context_moe", k2=0)
    rep = moe_run["report"]
    if not rep["loss_last"] < rep["loss_first"]:
        raise AssertionError(f"long_context_moe: loss not descending: {rep}")
    log(f"long_context_moe (ring + group-local routing, {lc_moe.moe_experts} experts, capacity "
        f"{lc_moe.moe_capacity}, {param_count(lc_moe)} params, {lc_moe.n_layers} layers) on "
        f"moe_mesh([0], model=1, expert=1) {moe_run['mesh']}: {rep['steps']} steps, loss "
        f"{rep['loss_first']:.6f} -> {rep['loss_last']:.6f}, step p50 "
        f"{rep['step_seconds_p50'] * 1e3:.3f} ms, peak memory allocated "
        f"{moe_run['peak_gb']:.3f} GB; 0 K1 and 0 K2 launches")
    log("activation bound (local * 1.4 < global, moe.routing_temp_comparison): not run on one "
        "card; it needs moe_mesh(model=2, expert=2), 4 ranks, as the reference's stanza needs "
        "n_devices % 4 == 0; `--cards 4` runs it")
    return view, got["launches"]


# The sharded step on several cards against the one-card step on the same
# weights: bf16 partial sums rounded a rank and summed across ranks move
# the losses by rounding (the CPU tests' 8-rank tolerances).
CARDS_FIRST_LOSS_RTOL = 1e-3
CARDS_LOSS_RTOL = 1e-2


def check_cards_run(runs, cfg, steps: int, single_losses, label: str):
    """One run on every rank of the cards' mesh (``runs``, by rank)
    against the one-card run: ok with one global loss on every rank, K2
    launched steps x 2 x layers on each, the losses within
    ``CARDS_*_RTOL`` of one card's.  Returns the relative gaps."""
    first = runs[0]
    for rank, res in enumerate(runs):
        check_run(res, cfg, steps, f"{label}, rank {rank}")
        if res["losses"] != first["losses"]:
            raise AssertionError(f"{label}, rank {rank}: losses {res['losses']} vs rank 0's "
                                 f"{first['losses']}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(first["losses"], single_losses)]
    if gaps[0] > CARDS_FIRST_LOSS_RTOL or max(gaps) > CARDS_LOSS_RTOL:
        raise AssertionError(f"{label}: {first['losses']} vs one card {single_losses}: gaps {gaps}")
    return gaps


def phase_cards(torch, burnin, mfu, validate, cards: int, steps: int = 6) -> dict:
    """``--cards N`` (N a multiple of 4): the flash family at the
    trainer's width on card 0 alone, then in N spawned workers, a card
    each, the same sharded over `burnin_mesh` of N ranks and the
    long_context_a2a family (Ulysses + flash, the same width) over the
    same mesh (each: one global loss on every rank, K2's launches ==
    steps x 2 x layers on every rank, the losses against the one-card
    losses within ``CARDS_*_RTOL``: on one card Ulysses is the flash
    family's arithmetic), and the activation bound on every rank
    (`moe.routing_temp_comparison` on `moe_mesh` with model 2 and expert
    2: ``local * 1.4 < global``, the reference's stanza); then ``python
    -m tpu_dra_torch.parallel.validate --train 2`` over the N cards (the
    checks, the bus bandwidth, the sharded, ring and MoE stages) and
    ``--family NAME --train 2`` for moe, long_context_a2a and
    long_context_moe (each over its `models.family_mesh`).  Returns the
    numbers for the JSON line."""
    cfg = dataclasses.replace(mfu.chip_sized_config(80), flash_attention=True)
    a2a = dataclasses.replace(cfg, ulysses_attention=True)
    with recorded_losses(burnin) as losses:
        single = burnin.train(cfg, steps=steps, device="cuda")
    single_losses = [float(l) for l in losses]
    del losses
    if not single.ok:
        raise AssertionError(f"one-card train: {single}")
    log(f"one card: losses {single_losses}, step p50 {single.step_seconds_p50 * 1e3:.3f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    results = run_sharded_ranks(validate, cfg, steps, world=cards, families=False,
                                also=[{"config": a2a, "steps": steps}], bound=True, timeout=900)
    wall = time.perf_counter() - t
    numbers = {"cards": cards, "one_card_losses": single_losses,
               "one_card_step_p50_s": single.step_seconds_p50}
    for label, c, runs in (("flash", cfg, results), ("long_context_a2a", a2a,
                                                     [r["also"][0] for r in results])):
        gaps = check_cards_run(runs, c, steps, single_losses, label)
        p50s = [res["report"]["step_seconds_p50"] for res in runs]
        log(f"{label} sharded over {cards} cards, mesh {runs[0]['mesh']}: losses "
            f"{runs[0]['losses']} (relative gaps to one card {gaps}); step p50 by rank "
            f"{[f'{p * 1e3:.3f}' for p in p50s]} ms against one card's "
            f"{single.step_seconds_p50 * 1e3:.3f} ms; {runs[0]['launches']} K2 launches a rank; "
            f"peak memory by rank {[round(r['peak_gb'], 3) for r in runs]} GB")
        numbers[label] = {"mesh": runs[0]["mesh"], "losses": runs[0]["losses"],
                          "step_p50_s": p50s, "peak_gb": [r["peak_gb"] for r in runs]}
    bounds = [res["bound"] for res in results]
    for rank, (glob, local) in enumerate(bounds):
        if not local * 1.4 < glob:
            raise AssertionError(f"activation bound, rank {rank}: local {local} B * 1.4 >= "
                                 f"global {glob} B")
    log(f"activation bound on moe_mesh(model=2, expert=2) of {cards} ranks: (global, local) peak "
        f"bytes above the start of one MoE forward by rank {bounds}; ratios "
        f"{[round(g / l, 3) for g, l in bounds]} (local * 1.4 < global on every rank); workers' "
        f"wall {wall:.3f} s")
    numbers["activation_bound_bytes"] = bounds

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPU_VISIBLE_DEVICES=",".join(str(i) for i in range(cards)))
    reports = {}
    for args in (["--train", "2"], ["--family", "moe", "--train", "2"],
                 ["--family", "long_context_a2a", "--train", "2"],
                 ["--family", "long_context_moe", "--train", "2"]):
        p = subprocess.run([sys.executable, "-m", "tpu_dra_torch.parallel.validate", *args],
                           cwd=root, env=env, capture_output=True, text=True, timeout=600)
        lines = p.stdout.strip().splitlines()
        rep = json.loads(lines[-1]) if lines else {}
        if p.returncode != 0 or rep.get("ok") is not True:
            raise AssertionError(f"validate {' '.join(args)}: exit {p.returncode}\n{p.stdout}\n"
                                 f"{p.stderr[-3000:]}")
        log(f"validate {' '.join(args)} over {cards} cards: {lines[-1][:1500]}")
        reports[" ".join(args)] = rep
    suite = reports["--train 2"]
    for key in ("train", "train_ring", "train_moe"):
        if not (suite.get(key) or {}).get("ok"):
            raise AssertionError(f"validate --train 2: {key} {suite.get(key)}")
    numbers["busbw_gbps"] = suite["busbw_gbps"]
    return numbers


def phase_cards_serving(torch, burnin, paged, quant, serve_mod, weights, validate, pa, fa,
                        cards: int) -> dict:
    """``--cards N``, serving: the main stream at full width through the
    paged gather engine on card 0 alone, bf16 and int8 (``kv_int8``);
    then in N spawned workers, a card each, the same over `burnin_mesh`
    of N ranks (data N / 4, fsdp 2, model 2; `_mesh_serving`): every
    rank's tokens the same, and one card's up to near-ties (PERF.md §2:
    a first divergence at a top-2 margin within 2 bf16 ulps of the row's
    largest logit, recomputed on card 0), K1 and K2 never launched, each
    rank's numbers and bytes; then ``validate --family dense --serve``
    and ``--family moe --serve --int8`` over the N cards.  Returns the
    numbers for the JSON line."""
    cfg = burnin.BurninConfig(**SERVE_WIDTH)
    stream = make_stream(cfg.vocab)
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = burnin.init_params(cfg, gen, device="cuda")
    params = {"bf16": weights.cast_matrices(full), "int8": quant.quantize_params(full)}
    del full
    gc.collect()
    torch.cuda.empty_cache()
    one = {}
    for form, p in params.items():
        one[form] = _mesh_engine_run(serve_mod.ServeEngine, quant, pa, fa, p, cfg, stream, None,
                                     form)
        log(f"one card, paged gather engine {form}: {check_mesh_run(one[form], 'one card')}")
    logits_at = {"bf16": dense_logits_at(burnin, params["bf16"], cfg),
                 "int8": int8_logits_at(torch, paged, params["int8"], cfg)}
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    results = run_ranks(validate, _serve_rank, {"world": cards, "one_card": False}, cards, 900,
                        "sharded serving")
    numbers = {"cards": cards, "mesh": results[0]["mesh"],
               "one_card": {form: {**run["numbers"], "weight_bytes": run["weight_bytes"],
                                   "pool_bytes": run["pool_bytes"]}
                            for form, run in one.items()}}
    prompts = {rid: p for rid, (p, _) in enumerate(stream)}
    for form in ("bf16", "int8"):
        label = f"paged {form}"
        first = results[0][label]["tokens"]
        for rank, res in enumerate(results):
            line = check_mesh_run(res[label], f"{cards} cards {form}, rank {rank}")
            if res[label]["tokens"] != first:
                raise AssertionError(f"{cards} cards {form}: rank {rank}'s tokens differ from "
                                     "rank 0's")
            log(f"{cards} cards, mesh {results[0]['mesh']}, paged engine {form}, rank {rank}: "
                f"{line}")
        got = {rid: _Gen(toks, prompts[rid]) for rid, toks in first.items()}
        want = {rid: _Gen(toks, prompts[rid]) for rid, toks in one[form]["tokens"].items()}
        check_near_ties(torch, got, want, logits_at[form], f"{cards} cards {form} vs one card")
        numbers[form] = [{**res[label]["numbers"], "weight_bytes": res[label]["weight_bytes"],
                          "pool_bytes": res[label]["pool_bytes"]} for res in results]
    for rank, res in enumerate(results):
        line = check_mesh_disagg(res["disagg"], results[0]["disagg"],
                                 f"{cards} cards disagg, rank {rank}")
        log(f"{cards} cards, mesh {results[0]['mesh']}, DisaggServer (both tiers on the mesh), "
            f"rank {rank}, tokens and step records rank 0's: {line}")
    for mode, run in results[0]["disagg"].items():
        got = {rid: _Gen(toks, prompts[rid]) for rid, toks in run["tokens"].items()}
        want = {rid: _Gen(toks, prompts[rid]) for rid, toks in one["bf16"]["tokens"].items()}
        check_near_ties(torch, got, want, logits_at["bf16"],
                        f"{cards} cards disagg {mode} vs one card")
    numbers["disagg"] = {mode: [res["disagg"][mode]["numbers"] for res in results]
                         for mode in results[0]["disagg"]}
    log(f"sharded serving workers' wall {time.perf_counter() - t:.3f} s")
    del params, logits_at
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPU_VISIBLE_DEVICES=",".join(str(i) for i in range(cards)))
    for args in (["--family", "dense", "--serve"], ["--family", "moe", "--serve", "--int8"]):
        p = subprocess.run([sys.executable, "-m", "tpu_dra_torch.parallel.validate", *args],
                           cwd=root, env=env, capture_output=True, text=True, timeout=600)
        lines = p.stdout.strip().splitlines()
        rep = json.loads(lines[-1]) if lines else {}
        if p.returncode != 0 or rep.get("ok") is not True:
            raise AssertionError(f"validate {' '.join(args)}: exit {p.returncode}\n{p.stdout}\n"
                                 f"{p.stderr[-3000:]}")
        log(f"validate {' '.join(args)} over {cards} cards: {lines[-1][:1500]}")
        numbers[" ".join(args)] = rep
    return numbers


# -- the pipeline, and the stream-fed trainer and checkpoints on the mesh ------

PIPE_LOSS_RTOL = 1e-3  # pipelined (4 microbatches of 4 rows) against one device
PIPE_STEPS = 6
PIPE_MOE_LAYERS = 4  # the pipelined family (2 experts) cut to 4 layers on the cards
ELASTIC_RTOL = 2e-3  # the reference's own bound (tests/test_ckpt.py)
PIPE_REFUSAL = "ValueError: 1 devices not divisible into 2 stages x 1 model"


def _train_run(torch, burnin, fa, pa, fn) -> dict:
    """``fn()`` (a training run returning a `TrainReport`) with its losses
    recorded, the card's peak allocation and K1's and K2's launches
    counted from 0 just before."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(pa, fa)
    with recorded_losses(burnin) as losses:
        report = fn()
    return {"report": dataclasses.asdict(report), "losses": [float(l) for l in losses],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **_launches(pa, fa)}


def _pipe_one_card(torch, mods, plan) -> dict:
    """The new paths on a one-rank NCCL group: (a) the pipelined trainer
    (dense, `pipeline_mesh([0], stages=1)`, M = 4) against the one-device
    trainer on the same seeded weights and batch, and the pipelined
    family (2 experts) at 4 layers; (b) `data.train_on_stream` of the
    flash family on `burnin_mesh([0])` against one device's, with the
    rank's prefetched batches against the host's; (c) checkpoints at 2
    layers: a round trip on the mesh with its rates, a run interrupted on
    the mesh and resumed on one device and the reverse, the fall-back past
    a torn shard beside a ``.tmp`` orphan."""
    import shutil
    import tempfile

    models, burnin, ckpt, data = mods["models"], mods["burnin"], mods["ckpt"], mods["data"]
    mfu, pipeline, spmd, fa, pa = mods["mfu"], mods["pipeline"], mods["spmd"], mods["fa"], mods["pa"]
    out = {}
    cfg = mfu.chip_sized_config(80)  # dense attention: the pipeline refuses flash
    out["one device"] = _train_run(torch, burnin, fa, pa,
                                   lambda: burnin.train(cfg, steps=PIPE_STEPS, device="cuda"))
    pmesh = pipeline.pipeline_mesh([0], stages=1)
    pcfg = dataclasses.replace(cfg, pipeline_stages=1, pipeline_microbatches=4)
    out["pipelined"] = _train_run(torch, burnin, fa, pa,
                                  lambda: burnin.train(pcfg, pmesh, steps=PIPE_STEPS))
    width = dict(SERVE_WIDTH, n_layers=PIPE_MOE_LAYERS)
    out["pipelined moe"] = _train_run(torch, burnin, fa, pa, lambda: models.train_family(
        "pipelined", pmesh, steps=3, **width))

    flash = dataclasses.replace(cfg, flash_attention=True)
    bmesh = burnin.burnin_mesh([0])
    place = spmd.Place(bmesh)
    stream = data.synthetic_stream(flash, seed=3)
    host = [next(stream) for _ in range(4)]
    pf = data.prefetch_to_device(iter(host), size=2, mesh=bmesh, spec=burnin.token_spec(flash))
    got = list(pf)
    want = [h[spmd.local_slices(burnin.token_spec(flash), h.shape, place.sizes, place.coords)]
            for h in host]
    out["prefetch"] = {"equal": all(g.device.type == "cuda" and torch.equal(g.cpu(), w)
                                    for g, w in zip(got, want)) and len(got) == len(host),
                       "waits": pf.waits, "side stream": pf.stream is not None
                       and pf.stream != torch.cuda.current_stream()}
    del got, pf
    for label, mesh in (("stream one device", None), ("stream mesh", bmesh)):
        out[label] = _train_run(torch, data, fa, pa, lambda: data.train_on_stream(
            flash, mesh, steps=PIPE_STEPS, seed=0, device="cuda"))

    c2 = dataclasses.replace(flash, n_layers=2)
    state_bytes = 2 * 4 * mfu.param_count(c2)  # f32 params and momentum
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    try:
        out["free_gb"] = shutil.disk_usage(root).free / 1e9
        if shutil.disk_usage(root).free < 3 * state_bytes:
            raise AssertionError(f"{out['free_gb']} GB free, the phase keeps up to 3 states")
        path = os.path.join(root, "round_trip")
        _, state = burnin.make_train_step(c2, bmesh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.save_state(path, state, step=1, mesh=bmesh, config=c2)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        restored = ckpt.restore_state(path, c2, bmesh, step=1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        a = burnin._leaves(state[0]) + burnin._leaves(state[1])
        b = burnin._leaves(restored[0]) + burnin._leaves(restored[1])
        out["round trip"] = {
            "bitwise": len(a) == len(b) and all(x.dtype == y.dtype and x.device == y.device
                                                and torch.equal(x, y) for x, y in zip(a, b)),
            "files": sorted(os.listdir(os.path.join(path, "1"))), "state_bytes": state_bytes,
            "save_s": save_s, "restore_s": restore_s}
        del state, restored, a, b
        shutil.rmtree(path)
        gc.collect()
        torch.cuda.empty_cache()
        _zero_launches(pa, fa)
        full_path = os.path.join(root, "full")
        _, full = ckpt.train_with_resume(c2, full_path, steps=4, device="cuda")
        shutil.rmtree(full_path)
        m2d = os.path.join(root, "mesh_then_device")
        _, first = ckpt.train_with_resume(c2, m2d, bmesh, steps=2)
        _, second = ckpt.train_with_resume(c2, m2d, steps=2, device="cuda")
        shutil.rmtree(m2d)
        d2m = os.path.join(root, "device_then_mesh")
        _, third = ckpt.train_with_resume(c2, d2m, steps=2, device="cuda")
        _, fourth = ckpt.train_with_resume(c2, d2m, bmesh, steps=2)
        out["resume"] = {"full": full, "mesh then device": first + second,
                         "device then mesh": third + fourth, **_launches(pa, fa)}
        # Step 4 (the mesh's shards) torn under its marker, a killed save
        # beside it: the restore falls back to step 2 (one device's file).
        os.remove(os.path.join(d2m, "4", ckpt.SHARD_FILE.format(0, 1)))
        os.makedirs(os.path.join(d2m, ".tmp.9.deadbeef"))
        fell = ckpt.restore_state(d2m, c2, bmesh)
        step2 = ckpt.restore_state(d2m, c2, bmesh, step=2)
        out["fall-back"] = (ckpt.latest_step(d2m) == 4 and all(
            torch.equal(x, y) for x, y in zip(burnin._leaves(fell[0]), burnin._leaves(step2[0]))))
        del fell, step2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _pipe_cards(torch, mods, plan) -> dict:
    """The pipelined family at full width cut to `PIPE_MOE_LAYERS` layers
    over `models.family_mesh("pipelined")` of every rank with
    ``plan["stages"]`` stages, for `PIPE_STEPS` steps."""
    models, burnin, fa, pa = mods["models"], mods["burnin"], mods["fa"], mods["pa"]
    world = plan["world"]
    mesh = models.family_mesh("pipelined", range(world), stages=plan["stages"])
    width = dict(SERVE_WIDTH, n_layers=PIPE_MOE_LAYERS)
    run = _train_run(torch, burnin, fa, pa, lambda: models.train_family(
        "pipelined", mesh, steps=PIPE_STEPS, **width))
    run["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return run


def _elastic_cards(torch, mods, plan) -> dict:
    """`ckpt.train_with_resume` of the flash family at 2 layers over
    `burnin.burnin_mesh` of every rank in ``plan["root"]``: with
    ``plan["save"]``, 5 uninterrupted steps and 3 saved each step; else 2
    steps resumed from those 3."""
    burnin, ckpt, mfu = mods["burnin"], mods["ckpt"], mods["mfu"]
    mesh = burnin.burnin_mesh(range(plan["world"]))
    c2 = dataclasses.replace(mfu.chip_sized_config(80), flash_attention=True, n_layers=2)
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}
    elastic = os.path.join(plan["root"], "elastic")
    if plan["save"]:
        full = os.path.join(plan["root"], "full")
        _, out["full"] = ckpt.train_with_resume(c2, full, mesh, steps=5, save_every=100)
        t = time.perf_counter()
        _, out["first"] = ckpt.train_with_resume(c2, elastic, mesh, steps=3, save_every=1)
        out["wall_s"] = time.perf_counter() - t
    else:
        t = time.perf_counter()
        out["second"] = ckpt.train_with_resume(c2, elastic, mesh, steps=2, save_every=1)
        out["wall_s"] = time.perf_counter() - t
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


PIPE_MODES = {"one card": _pipe_one_card, "cards": _pipe_cards, "elastic": _elastic_cards}


def _pipeline_rank(rank: int, init_method: str, plan: dict, out) -> None:
    """Rank ``rank`` of a NCCL group of ``plan["world"]`` (a card a rank)
    running ``PIPE_MODES[plan["mode"]]``.  Puts ``(rank, result)`` on
    ``out``.  Runs in a spawned process."""
    try:
        import torch

        from tpu_dra_torch import models
        from tpu_dra_torch.parallel import burnin, ckpt, data, gang, mfu, pipeline, spmd
        from tpu_dra_torch.parallel.kernels import flash_attn as fa
        from tpu_dra_torch.parallel.kernels import paged_attn as pa

        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gang.join_group(init_method, world_size=plan["world"], rank=rank, device=f"cuda:{rank}",
                        timeout_s=300)
        mods = {"models": models, "burnin": burnin, "ckpt": ckpt, "data": data, "mfu": mfu,
                "pipeline": pipeline, "spmd": spmd, "fa": fa, "pa": pa}
        out.put((rank, PIPE_MODES[plan["mode"]](torch, mods, plan)))
    except Exception:
        out.put((rank, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def gap_to(losses, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(losses, want))


def phase_pipeline(torch, ckpt, validate) -> dict:
    """Training on the mesh, completed, on one card: `_pipe_one_card` in a
    spawned one-rank NCCL worker, each part held to its contract; then
    ``python -m tpu_dra_torch.parallel.validate --family pipelined
    --train 2`` as a subprocess (one card: the reference's
    `pipeline_mesh` refusal, exit 1).  Returns K1's and K2's launches on
    each new path."""
    got = run_ranks(validate, _pipeline_rank, {"mode": "one card", "world": 1}, 1, 900,
                    "pipeline")[0]
    one, pp, moe = got["one device"], got["pipelined"], got["pipelined moe"]
    for label, run, steps in (("one device", one, PIPE_STEPS), ("pipelined", pp, PIPE_STEPS),
                              ("pipelined moe", moe, 3)):
        rep = run["report"]
        if rep["error"] or rep["steps"] != steps or not all(map(math.isfinite, run["losses"])):
            raise AssertionError(f"{label}: {rep}")
        if run["k1"] or run["k2"]:
            raise AssertionError(f"{label}: K1 {run['k1']}, K2 {run['k2']} launches (want 0)")
    if not (one["report"]["ok"] and pp["report"]["ok"]):
        raise AssertionError(f"one device {one['report']}, pipelined {pp['report']}")
    gap = gap_to(pp["losses"], one["losses"])
    if gap > PIPE_LOSS_RTOL:
        raise AssertionError(f"pipelined losses {pp['losses']} vs one device {one['losses']}: "
                             f"rel gap {gap} > {PIPE_LOSS_RTOL}")
    p50, p50_one = pp["report"]["step_seconds_p50"], one["report"]["step_seconds_p50"]
    log(f"pipelined trainer (dense, full width, pipeline_mesh([0], stages=1), M 4, "
        f"{PIPE_STEPS} steps): losses {pp['losses']} against the one-device trainer's "
        f"{one['losses']}: max relative gap {gap:.3e} (tol {PIPE_LOSS_RTOL}); step p50 "
        f"{p50 * 1e3:.3f} ms against {p50_one * 1e3:.3f} ms ({p50 / p50_one:.4f}x); peak "
        f"memory allocated {pp['peak_gb']:.3f} GB against {one['peak_gb']:.3f} GB; K1 "
        f"{pp['k1']}, K2 {pp['k2']} launches")
    log(f"pipelined family ({PIPE_MOE_LAYERS} layers, 2 experts, full width) on the same mesh: "
        f"3 steps, loss {moe['report']['loss_first']:.6f} -> {moe['report']['loss_last']:.6f}, "
        f"step p50 {moe['report']['step_seconds_p50'] * 1e3:.3f} ms, peak memory allocated "
        f"{moe['peak_gb']:.3f} GB, K1 {moe['k1']}, K2 {moe['k2']} launches")

    pf = got["prefetch"]
    if not (pf["equal"] and pf["side stream"] and pf["waits"] == 4):
        raise AssertionError(f"prefetch on the mesh: {pf}")
    s1, sm = got["stream one device"], got["stream mesh"]
    flash_layers = 8
    for label, run in (("one device", s1), ("mesh", sm)):
        rep = run["report"]
        if not rep["ok"] or rep["error"] or rep["steps"] != PIPE_STEPS:
            raise AssertionError(f"train_on_stream {label}: {rep}")
        if run["k2"] != PIPE_STEPS * 2 * flash_layers or run["k1"]:
            raise AssertionError(f"train_on_stream {label}: K2 {run['k2']}, K1 {run['k1']}")
    if sm["losses"] != s1["losses"]:
        raise AssertionError(f"train_on_stream on burnin_mesh([0]) {sm['losses']} vs one device "
                             f"{s1['losses']}: not bitwise")
    log(f"train_on_stream (flash, full width) on burnin_mesh([0]): 4 prefetched batches equal "
        f"to the rank's slices of the host batches (side stream, {pf['waits']} event waits); "
        f"losses {sm['losses']} bitwise the one-device stream-fed trainer's; step p50 "
        f"{sm['report']['step_seconds_p50'] * 1e3:.3f} ms against "
        f"{s1['report']['step_seconds_p50'] * 1e3:.3f} ms; {sm['k2']} K2 launches, 0 K1")

    rt, res = got["round trip"], got["resume"]
    if not rt["bitwise"] or rt["files"] != [ckpt.COMPLETE_MARKER, ckpt.SHARD_FILE.format(0, 1)]:
        raise AssertionError(f"mesh checkpoint round trip: {rt}")
    if res["mesh then device"] != res["full"] or res["device then mesh"] != res["full"]:
        raise AssertionError(f"resumes {res} not bitwise the uninterrupted run's")
    if not got["fall-back"]:
        raise AssertionError("the mesh restore did not fall back past the torn shard to step 2")
    gbs = rt["state_bytes"] / 1e9
    log(f"checkpoints on burnin_mesh([0]) (flash, 2 layers, {gbs:.3f} GB a state, "
        f"{got['free_gb']:.3f} GB free): round trip bitwise, save {rt['save_s']:.3f} s "
        f"({gbs / rt['save_s']:.3f} GB/s), restore {rt['restore_s']:.3f} s "
        f"({gbs / rt['restore_s']:.3f} GB/s); uninterrupted {res['full']}, interrupted on the "
        f"mesh and resumed on one device {res['mesh then device']}, and the reverse "
        f"{res['device then mesh']}: bitwise; a torn shard beside a .tmp orphan fell back to "
        f"step 2; {res['k2']} K2 launches")

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPU_VISIBLE_DEVICES="0")
    p = subprocess.run([sys.executable, "-m", "tpu_dra_torch.parallel.validate", "--family",
                        "pipelined", "--train", "2"], cwd=root, env=env, capture_output=True,
                       text=True, timeout=300)
    lines = p.stdout.strip().splitlines()
    rep = json.loads(lines[-1]) if lines else {}
    if p.returncode != 1 or rep.get("ok") is not False or rep.get("error") != PIPE_REFUSAL:
        raise AssertionError(f"validate --family pipelined --train 2: exit {p.returncode}\n"
                             f"{p.stdout}\n{p.stderr[-3000:]}")
    log(f"validate --family pipelined --train 2 on one card: exit {p.returncode}, {lines[-1]}")
    return {"k1": {"pipelined train": pp["k1"], "pipelined moe train": moe["k1"],
                   "mesh train_on_stream": sm["k1"]},
            "k2": {"pipelined train": pp["k2"], "pipelined moe train": moe["k2"],
                   "mesh train_on_stream": sm["k2"],
                   "train_with_resume (one-rank mesh and one device)": res["k2"]}}


def phase_cards_pipeline(torch, validate, cards: int) -> dict:
    """``--cards N``, the pipeline and elastic resume: the pipelined family
    (2 experts, full width cut to `PIPE_MOE_LAYERS` layers) on one card
    with pipe 1, then over the first 4 cards on (data 1, pipe 2, model
    2), the losses within ``CARDS_*_RTOL``, each rank's step p50 and peak
    bytes beside the GPipe bubble (P-1)/(M+P-1); then
    `ckpt.train_with_resume` saved on `burnin_mesh` of 4 cards (3 steps
    of 5) and resumed on 2, the resumed losses within ``ELASTIC_RTOL`` of
    the uninterrupted run's.  Returns the numbers for the JSON line."""
    import shutil
    import tempfile

    one = run_ranks(validate, _pipeline_rank, {"mode": "cards", "world": 1, "stages": 1}, 1,
                    900, "pipelined, one card")[0]
    runs = run_ranks(validate, _pipeline_rank, {"mode": "cards", "world": 4, "stages": 2}, 4,
                     900, "pipelined, 4 cards")
    first = runs[0]
    for rank, run in enumerate([one] + runs):
        rep = run["report"]
        if not rep["ok"] or rep["error"] or rep["steps"] != PIPE_STEPS or run["k1"] or run["k2"]:
            raise AssertionError(f"pipelined run {rank}: {run}")
        if rank and run["losses"] != first["losses"]:
            raise AssertionError(f"pipelined 4 cards: rank {rank - 1}'s losses {run['losses']} "
                                 f"vs rank 0's {first['losses']}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(first["losses"], one["losses"])]
    if gaps[0] > CARDS_FIRST_LOSS_RTOL or max(gaps) > CARDS_LOSS_RTOL:
        raise AssertionError(f"pipelined 4 cards {first['losses']} vs one card {one['losses']}: "
                             f"gaps {gaps}")
    M, P = 4, first["mesh"]["pipe"]
    p50s = [r["report"]["step_seconds_p50"] for r in runs]
    p50_one = one["report"]["step_seconds_p50"]
    log(f"pipelined family ({PIPE_MOE_LAYERS} layers, 2 experts, full width) on mesh "
        f"{first['mesh']} of 4 cards against one card (pipe 1): losses {first['losses']} vs "
        f"{one['losses']} (relative gaps {gaps}); step p50 by rank "
        f"{[f'{p * 1e3:.3f}' for p in p50s]} ms against one card's {p50_one * 1e3:.3f} ms "
        f"({p50_one / max(p50s):.4f}x); GPipe bubble (P-1)/(M+P-1) = {(P - 1) / (M + P - 1)}; "
        f"peak memory by rank {[round(r['peak_gb'], 3) for r in runs]} GB against one card's "
        f"{one['peak_gb']:.3f} GB; 0 K1 and 0 K2 launches")
    numbers = {"pipelined": {"mesh": first["mesh"], "losses": first["losses"],
                             "one_card_losses": one["losses"], "step_p50_s": p50s,
                             "one_card_step_p50_s": p50_one,
                             "bubble": (P - 1) / (M + P - 1),
                             "peak_gb": [r["peak_gb"] for r in runs],
                             "one_card_peak_gb": one["peak_gb"]}}
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        saved = run_ranks(validate, _pipeline_rank,
                          {"mode": "elastic", "world": 4, "save": True, "root": root}, 4, 900,
                          "elastic save")
        resumed = run_ranks(validate, _pipeline_rank,
                            {"mode": "elastic", "world": 2, "save": False, "root": root}, 2, 900,
                            "elastic resume")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    full, first3 = saved[0]["full"], saved[0]["first"]
    final, second = resumed[0]["second"]
    if any(r["full"] != full or r["first"] != first3 for r in saved) or any(
            r["second"] != resumed[0]["second"] for r in resumed):
        raise AssertionError(f"elastic: ranks disagree: {saved} {resumed}")
    gap3 = gap_to(first3, full[:3])
    gap2 = gap_to(second, full[3:])
    if final != 5 or gap3 > 1e-5 or gap2 > ELASTIC_RTOL:
        raise AssertionError(f"elastic: uninterrupted {full}, first {first3}, resumed "
                             f"{second} (step {final})")
    log(f"elastic resume (flash, 2 layers): uninterrupted {full} on {saved[0]['mesh']}; "
        f"3 steps saved each step there {first3} (gap {gap3:.3e}), resumed on "
        f"{resumed[0]['mesh']} of 2 cards {second} (relative gap {gap2:.3e}, tol {ELASTIC_RTOL}); "
        f"wall of the 3 saved steps {saved[0]['wall_s']:.3f} s, of the 2 resumed (restore "
        f"included) {resumed[0]['wall_s']:.3f} s")
    numbers["elastic"] = {"full": full, "first": first3, "resumed": second,
                          "save_mesh": saved[0]["mesh"], "resume_mesh": resumed[0]["mesh"]}
    return numbers


# The payload's runs: (arguments, TPU_VISIBLE_DEVICES, exit code wanted).
PAYLOAD_RUNS = (
    (["--train", "2"], "0", 0),
    ([], "0,1", 1),
    (["--family", "flash", "--train", "2"], "0", 0),
    (["--family", "dense", "--serve"], "0", 0),
)


def burnin_hbm(mfu):
    """The card's table entry and the saxpy probe of its memory rate."""
    perf = mfu.chip_perf_for("cuda")
    if perf is None or perf.bf16_tflops * 1e12 != H100_BF16_FLOPS:
        raise AssertionError(f"chip_perf_for: {perf}, want the 989 TFLOP/s bf16 peak")
    hbm = mfu.measure_hbm_bandwidth(device="cuda")
    if not hbm.ok or not 0 < hbm.fraction_of_peak <= 1.05:
        raise AssertionError(f"measure_hbm_bandwidth: {hbm}")
    log(f"burn-in hbm: table entry {perf}; saxpy over 2 x {hbm.array_mib:.1f} MiB f32: "
        f"{hbm.gbps:.3f} GB/s of the {hbm.peak_gbps:.0f} GB/s peak (fraction "
        f"{hbm.fraction_of_peak:.4f})")


def burnin_stream(torch, burnin, data, prng, fa, cfg, train_p50: float, device="cuda") -> int:
    """`synthetic_stream` against the same draws made on the card, the
    prefetch's side stream and event waits with every batch equal to its
    host source, then `train_on_stream` at ``cfg`` for 6 steps with K2's
    launches counted.  Returns the launches."""
    stream = data.synthetic_stream(cfg, seed=0)
    key = prng.key(0, device=device)
    for i in range(3):
        key, sub = prng.split(key)
        host = next(stream)
        on_card = burnin.sample_tokens(cfg, device=device, key=sub)
        if host.dtype != torch.int32 or not torch.equal(host, on_card.cpu()):
            raise AssertionError(f"synthetic_stream batch {i} differs from the draw on {device}")
    sources = []

    def recorded(it):
        for batch in it:
            sources.append(batch.clone())
            yield batch

    n = 8
    pf = data.prefetch_to_device(recorded(data.synthetic_stream(cfg, seed=1)), size=2,
                                 device=device)
    for i in range(n):
        got = next(pf)
        if not torch.equal(got.cpu(), sources[i]):
            raise AssertionError(f"prefetched batch {i} differs from its host source")
    if device == "cuda" and (pf.stream is None or pf.stream == torch.cuda.current_stream()
                             or pf.waits != n):
        raise AssertionError(f"prefetch: side stream {pf.stream}, waits {pf.waits} of {n}")
    del pf, sources

    steps = 6
    fa.flash_attention_forward.launches = 0  # count only this path's launches
    report = data.train_on_stream(cfg, steps=steps, seed=0, device=device)
    launches = fa.flash_attention_forward.launches
    if not report.ok or report.error or report.steps != steps:
        raise AssertionError(f"train_on_stream: {report}")
    if cfg.flash_attention and launches != steps * 2 * cfg.n_layers:
        raise AssertionError(
            f"flash launches {launches} != {steps} steps x 2 x {cfg.n_layers} layers")
    log(f"burn-in stream: 3 batches of synthetic_stream equal to the draws on {device}; "
        f"{n} prefetched batches equal to their host sources (side stream, {n} event waits); "
        f"train_on_stream {report.steps} steps, loss {report.loss_first:.6f} -> "
        f"{report.loss_last:.6f} over distinct batches, step p50 "
        f"{report.step_seconds_p50 * 1e3:.3f} ms against burnin.train's "
        f"{train_p50 * 1e3:.3f} ms in this run, {launches} flash launches")
    return launches


def burnin_ckpt(torch, burnin, ckpt, mfu, fa, cfg, device="cuda") -> int:
    """Checkpoints of ``cfg``'s momentum state in a temporary directory:
    a bitwise round trip with its rates; an uninterrupted run of 4 steps
    against 2 steps, a restart and 2 more; the fallback past a torn step.
    Everything written is deleted.  Returns K2's launches in the runs."""
    import shutil
    import tempfile

    state_bytes = 2 * 4 * mfu.param_count(cfg)  # f32 params and momentum
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(root).free
    log(f"burn-in ckpt: {free / 1e9:.3f} GB free under {os.path.dirname(root)}; one state "
        f"{state_bytes / 1e9:.3f} GB ({mfu.param_count(cfg)} params, {cfg.n_layers} layers)")
    if free < 3 * state_bytes:  # at most three states on disk at once
        raise AssertionError(f"{free} bytes free, the phase keeps up to {3 * state_bytes}")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    try:
        path = os.path.join(root, "round_trip")
        _, state = burnin.make_train_step(cfg, device)
        sync()
        t = time.perf_counter()
        ckpt.save_state(path, state, step=1)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        restored = ckpt.restore_state(path, cfg, step=1, device=device)
        sync()
        restore_s = time.perf_counter() - t
        want, got = burnin._leaves(state[0]) + burnin._leaves(state[1]), \
            burnin._leaves(restored[0]) + burnin._leaves(restored[1])
        if len(want) != len(got) or not all(
                w.dtype == g.dtype and w.device == g.device and torch.equal(w, g)
                for w, g in zip(want, got)):
            raise AssertionError("restored state differs from the saved one")
        del state, restored, want, got
        shutil.rmtree(path)
        log(f"burn-in ckpt round trip: bitwise; save {save_s:.3f} s ({state_bytes / save_s / 1e9:.3f} "
            f"GB/s), restore {restore_s:.3f} s ({state_bytes / restore_s / 1e9:.3f} GB/s)")

        fa.flash_attention_forward.launches = 0
        full_path, resumed = os.path.join(root, "full"), os.path.join(root, "resumed")
        walls = []
        t = time.perf_counter()
        _, full = ckpt.train_with_resume(cfg, full_path, steps=4, device=device)
        walls.append(time.perf_counter() - t)
        shutil.rmtree(full_path)
        t = time.perf_counter()
        s1, first = ckpt.train_with_resume(cfg, resumed, steps=2, device=device)
        walls.append(time.perf_counter() - t)
        t = time.perf_counter()
        s2, second = ckpt.train_with_resume(cfg, resumed, steps=2, device=device)
        walls.append(time.perf_counter() - t)
        launches = fa.flash_attention_forward.launches
        if (s1, s2, ckpt.complete_steps(resumed)) != (2, 4, [2, 4]):
            raise AssertionError(f"steps {s1}, {s2}, complete {ckpt.complete_steps(resumed)}")
        if cfg.flash_attention and launches != 8 * 2 * cfg.n_layers:
            raise AssertionError(f"flash launches {launches} != 8 steps x 2 x {cfg.n_layers}")
        if first + second == full:
            how = "bitwise"
        else:
            # Not bitwise: the step has a nondeterministic op.  The resumed
            # losses must then lie within two uninterrupted runs' spread.
            again_path = os.path.join(root, "again")
            _, again = ckpt.train_with_resume(cfg, again_path, steps=4, device=device)
            shutil.rmtree(again_path)
            spread = max(abs(a - b) for a, b in zip(full, again))
            off = max(abs(a - b) for a, b in zip(first + second, full))
            if off > spread:
                raise AssertionError(f"resumed {first + second} vs uninterrupted {full} "
                                     f"(again {again}): off {off} > spread {spread}")
            how = (f"within the spread of two uninterrupted runs ({off} <= {spread}; "
                   f"uninterrupted runs differ: the step is not deterministic on the card)")
        log(f"burn-in ckpt resume: uninterrupted {full}, 2 + restart + 2 {first + second}: "
            f"{how}; {launches} flash launches; wall (s, init or restore, steps and one save "
            f"each) {', '.join(f'{w:.3f}' for w in walls)}")

        os.remove(os.path.join(resumed, "4", ckpt.STATE_FILE))  # torn under its marker
        os.makedirs(os.path.join(resumed, ".tmp.9.deadbeef"))  # a save killed midway
        fallback = ckpt.restore_state(resumed, cfg, device=device)
        step2 = ckpt.restore_state(resumed, cfg, step=2, device=device)
        if ckpt.latest_step(resumed) != 4 or not all(
                torch.equal(a, b) for a, b in zip(burnin._leaves(fallback[0]),
                                                  burnin._leaves(step2[0]))):
            raise AssertionError("restore did not fall back to step 2")
        try:
            ckpt.restore_state(resumed, cfg, step=4, device=device)
        except FileNotFoundError:
            pass
        else:
            raise AssertionError("an explicit restore of the torn step did not raise")
        del fallback, step2
        log("burn-in ckpt fallback: step 4 torn under its marker and a .tmp orphan beside it; "
            "restore fell back to step 2, bitwise")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _nccl_rank(init_method: str, out) -> None:
    """A one-rank NCCL group on card 0: the collective checks over its
    mesh.  Runs in a spawned process."""
    try:
        from tpu_dra_torch.parallel import collectives, gang, mesh

        gang.join_group(init_method, world_size=1, rank=0, device="cuda:0", timeout_s=120)
        m = mesh.slice_mesh("1x1x1")
        reports = [check(m, "x") for check in (collectives.psum_check,
                                               collectives.all_gather_check,
                                               collectives.ring_check)]
        reports.append(collectives.psum_bandwidth(m, "x", mbytes=64))
        reports.append(collectives.hierarchical_psum_check(m, "x", "y"))
        gang.barrier()
        out.put([(r.op, r.axis, r.n_devices, r.ok, r.error, r.seconds_p50) for r in reports])
    except Exception as e:
        out.put(f"{type(e).__name__}: {e}")
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def burnin_payload(validate):
    """`python -m tpu_dra_torch.parallel.validate` as a claiming pod runs
    it (four runs at once), then a one-rank NCCL group in a spawned
    worker."""
    import multiprocessing

    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for args, visible, _ in PAYLOAD_RUNS:
        env = dict(os.environ, TPU_VISIBLE_DEVICES=visible)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_dra_torch.parallel.validate", *args], cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (args, visible, want_rc), p, (out, err) in zip(PAYLOAD_RUNS, procs, outs):
        label = f"validate {' '.join(args)} (TPU_VISIBLE_DEVICES={visible})"
        lines = out.strip().splitlines()
        if p.returncode != want_rc or not lines:
            raise AssertionError(f"{label}: exit {p.returncode}, want {want_rc}\n{out}\n{err[-3000:]}")
        rep = json.loads(lines[-1])
        if "--family" in args:
            if rep.get("ok") is not True or rep.get("family") != args[1]:
                raise AssertionError(f"{label}: {rep}")
        elif visible == "0":
            train = rep.get("train") or {}
            if not (rep.get("ok") is True and rep.get("n_devices") == 1
                    and rep.get("expected_devices") == 1 and rep.get("platform") == "gpu"
                    and rep.get("checks") == [] and train.get("ok") is True
                    and train.get("loss_last", 1e9) < train.get("loss_first", 0)):
                raise AssertionError(f"{label}: {rep}")
        elif rep.get("ok") is not False or rep.get("errors") != [
                "claim allocated 2 chips but torch sees 1"]:
            raise AssertionError(f"{label}: {rep}")
        log(f"burn-in payload {label}: exit {p.returncode}, {lines[-1][:400]}")

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    worker = ctx.Process(target=_nccl_rank,
                         args=(f"tcp://127.0.0.1:{validate._free_port()}", out), daemon=True)
    worker.start()
    try:
        got = out.get(timeout=180)
    finally:
        worker.join(timeout=30)
        if worker.is_alive():
            worker.kill()
            worker.join()
    if isinstance(got, str) or not all(ok for _, _, _, ok, _, _ in got):
        raise AssertionError(f"one-rank NCCL checks: {got}")
    log(f"burn-in one-rank NCCL group: {got}")


def phase_burnin(torch, burnin, mfu, fa, data, ckpt, prng, validate, train_p50: float):
    """The burn-in payload a claiming pod runs, at the trainer's width:
    the memory probe, the stream-fed trainer, checkpoints (cut to 2
    layers), the validate program and the NCCL wiring.  Returns K2's
    launches on the stream-fed and the checkpointed paths."""
    t = time.perf_counter()
    burnin_hbm(mfu)
    cfg = dataclasses.replace(mfu.chip_sized_config(80), flash_attention=True)
    gc.collect()
    torch.cuda.empty_cache()
    parts = {"hbm": time.perf_counter() - t}
    t = time.perf_counter()
    stream_launches = burnin_stream(torch, burnin, data, prng, fa, cfg, train_p50)
    gc.collect()
    torch.cuda.empty_cache()
    parts["stream"] = time.perf_counter() - t
    t = time.perf_counter()
    ckpt_launches = burnin_ckpt(torch, burnin, ckpt, mfu, fa,
                                dataclasses.replace(cfg, n_layers=2))
    gc.collect()
    torch.cuda.empty_cache()
    parts["ckpt"] = time.perf_counter() - t
    t = time.perf_counter()
    burnin_payload(validate)
    parts["payload"] = time.perf_counter() - t
    log("burn-in parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return {"train_on_stream": stream_launches, "train_with_resume": ckpt_launches}


# K3 against its plain version: the same bf16 values, the online softmax
# rescaled every 64 positions in the kernel and every 128 in the plain
# version, so the probabilities round to bf16 at other points; 2**-7 of
# the output's scale (measured about 2**-9.6 at the engine's shapes).
K3_TOL = 2 ** -7
# The engine's served tokens against the plain reference at full width,
# mean gap a token: sound runs read under 1e-3 in the benchmark; a wrong
# latent read or routing reads gaps of the logits' scale (about 1).
MOONLIGHT_GAP_MEAN = 1e-2


def phase_moonlight(torch, serve_mod, mla_moe, k3):
    """Moonlight-16B-A3B at its published widths on one card: K3 at the
    engine's shapes against its plain version and timed beside its bound;
    then the whole model through the paged engine (128 slots, 768 prompt
    slots, 2048 new tokens, W 128): a few requests served through K3,
    its launches counted (one a layer a decode step), every prefill
    window replayed from its captured graph, the served tokens' logits
    against the plain reference's (`tests/ref_mla_moe.py`), and a
    decode step timed at 128 rows.  Returns K3's kernel row."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import ref_mla_moe as ref

    g = torch.Generator(device="cuda").manual_seed(20)
    B, NB, NW = 128, 2817, 22
    pool = torch.randn(NB, 128, 576, device="cuda", generator=g).to(torch.bfloat16)
    q = torch.randn(B, 16, 576, device="cuda", generator=g).to(torch.bfloat16)
    table = torch.randint(1, NB, (B, NW), device="cuda", generator=g, dtype=torch.int32)
    pos = torch.randint(0, NW * 128, (B,), device="cuda", generator=g, dtype=torch.int32)
    args = (q, pool, table, pos)
    kw = dict(v_dim=512, scale=192 ** -0.5)
    want = k3.mla_decode_plain(*args, **kw)
    got = k3.mla_decode(*args, **kw)
    err = (got - want).abs().max().item()
    assert err < K3_TOL * want.abs().max().item(), f"K3 vs plain: {err}"
    assert torch.equal(got, k3.mla_decode(*args, **kw)), "K3 is not repeatable"
    scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: k3.mla_decode(*args, **kw), scrub.zero_)
    plain_ms = time_ms(lambda: k3.mla_decode_plain(*args, **kw), scrub.zero_, n=10, warmup=2)
    nbytes = (pos.long() + 1).sum().item() * 1152 + B * 16 * (576 * 2 + 512 * 4)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    log(f"K3 at 128 rows, contexts 1-2816 (mean {pos.float().mean().item() + 1:.0f}): kernel "
        f"{kernel_ms:.6f} ms, plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms (bytes), "
        f"max abs err {err:.3e}, {k3.split_count(B, NW)} programs a row")
    del pool, q, table, pos, want, got, args, scrub

    cfg = mla_moe.MlaMoeConfig()
    params = mla_moe.init_params(cfg, 2026, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = serve_mod.ServeEngine(params, cfg, slots=128, prompt_slots=768, max_new_cap=2048,
                                prefix_window=128, device="cuda", record_routes=True)
    log(f"Moonlight engine built (weights {mla_moe.param_count(cfg)} parameters, prefill "
        f"windows captured) in {time.perf_counter() - t:.3f} s")
    rng = torch.Generator().manual_seed(21)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (1, 127, 128, 129, 384, 768)]
    k3.mla_decode.launches = 0  # count only the served requests' launches
    ids = [eng.submit(p, 16) for p in prompts]
    eng.run()
    launches = k3.mla_decode.launches
    assert launches == 27 * eng.device_steps, (launches, eng.device_steps)
    stats = eng.prefix_stats
    assert stats["prefill_windows_eager"] == 0 and stats["prefill_windows_graph"] == 6 * 6
    replayed = decode_paths([eng], "Moonlight engine")
    for _ in range(128):
        eng.submit(torch.randint(0, cfg.vocab_size, (384,), generator=rng).tolist(), 24)
    eng.tick()
    walls = []
    for _ in range(12):
        t = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    eng.run()
    peak = torch.cuda.max_memory_allocated()
    log(f"Moonlight decode tick at {eng.occupancy or 128} rows: median "
        f"{statistics.median(walls) * 1e3:.1f} ms; K3 launches {launches} = 27 x "
        f"{launches // 27} steps; prefill windows {stats['prefill_windows_graph']} replayed, 0 "
        f"eager; {replayed}; memory peak {peak} B ({peak / 80e9:.1%} of 80 GB)")
    done = [eng.request(i) for i in ids]
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    gaps = []
    with torch.no_grad(), ref.strict_fp32():
        for r in done:
            logits = ref.forward(params, torch.tensor(r.prompt + r.tokens[:-1], device="cuda"),
                                 dataclasses.asdict(cfg), routes=r.routes)[len(r.prompt) - 1:]
            served = torch.tensor(r.tokens, device="cuda")[:, None]
            gaps.append(logits.max(-1).values - logits.gather(-1, served)[:, 0])
    gap = torch.cat(gaps)
    log(f"Moonlight served tokens against the reference: mean gap {gap.mean().item():.3e}, "
        f"widest {gap.max().item():.3e} over {gap.numel()} tokens")
    assert gap.mean().item() < MOONLIGHT_GAP_MEAN
    return {
        "name": "mla_decode",
        "route": "triton",
        "source": "tpu_dra_torch/parallel/kernels/mla_decode.py",
        "replaces": None,  # no TPU kernel: the JAX package has no latent attention
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def main_cards(torch, cards: int) -> int:
    """``python3 chip_smoke.py --cards N``: `phase_cards`, the cards'
    serving, pipeline and fleet phases, then their JSON line, the card line
    and the result line."""
    if torch.cuda.device_count() < cards:
        print(f"chip_smoke: --cards {cards} needs {cards} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from tpu_dra_torch.fleet import fleet as fleet_mod
    from tpu_dra_torch.parallel import burnin, mfu, paged, quant, serve, validate, weights
    from tpu_dra_torch.parallel.kernels import _build
    from tpu_dra_torch.parallel.kernels import flash_attn as fa
    from tpu_dra_torch.parallel.kernels import paged_attn as pa

    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        log(f"cards: {cards} x {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
        t = time.perf_counter()
        log(f"build: {_build.build_all()} in {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        numbers = phase_cards(torch, burnin, mfu, validate, cards)
        log(f"phase cards: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        serving = phase_cards_serving(torch, burnin, paged, quant, serve, weights, validate, pa,
                                      fa, cards)
        log(f"phase cards serving: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        pipeline = phase_cards_pipeline(torch, validate, cards)
        log(f"phase cards pipeline and elastic resume: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        fleet = phase_cards_fleet(torch, burnin, serve, weights, quant, pa, fleet_mod, cards)
        log(f"phase cards fleet: {time.perf_counter() - t:.3f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"sharded_cards": numbers, "sharded_serving_cards": serving,
                      "pipeline_cards": pipeline, "fleet_cards": fleet}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args:
        if (len(args) != 2 or args[0] != "--cards" or not args[1].isdigit()
                or int(args[1]) < 4 or int(args[1]) % 4):
            print("usage: chip_smoke.py [--cards N], N a multiple of 4", file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return main_cards(torch, int(args[1]))
    started = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tpu_dra_torch import models
        from tpu_dra_torch.fleet import fleet as fleet_mod
        from tpu_dra_torch.parallel import (
            burnin, ckpt, data, decode, disagg, flash, mfu, moe, paged, prng, quant, ring,
            serve, speculative, spmd, swap, validate, weights,
        )
        from tpu_dra_torch.models import mla_moe
        from tpu_dra_torch.parallel.kernels import _build
        from tpu_dra_torch.parallel.kernels import flash_attn as fa
        from tpu_dra_torch.parallel.kernels import mla_decode as k3
        from tpu_dra_torch.parallel.kernels import paged_attn as pa
        from tpu_dra_torch.utils import metrics
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
        paged_row["launches"], greedy_line, greedy_done, gather_tokens, telemetry = phase_engine(
            torch, burnin, serve, weights, quant, pa, paged)
        log(f"phase engine: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        int8_row["launches"], int8_sampled, int8_gather_tokens = phase_engine_int8(
            torch, burnin, serve, weights, quant, pa, paged)
        int8_row["launches_by_path"] = {"int8 engine": int8_row["launches"],
                                        "int8 sampled": int8_sampled}
        log(f"phase int8 engine: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
        sampled = phase_sampled(torch, burnin, serve, prng, decode, speculative, weights, pa,
                                greedy_line)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        disagg_tokens = {}
        hierarchy = phase_kv_hierarchy(torch, burnin, serve, swap, disagg, weights, quant, pa,
                                       paged, disagg_tokens)
        log(f"phase KV hierarchy: {time.perf_counter() - t:.3f} s; kernel launches {hierarchy}")
        paged_row["launches_by_path"] = {"engine": paged_row["launches"], **telemetry, **sampled,
                                         **hierarchy}
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        fleet_launches = phase_fleet(torch, burnin, serve, weights, quant, pa, fleet_mod, metrics)
        paged_row["launches_by_path"].update(fleet_launches)
        log(f"phase fleet: {time.perf_counter() - t:.3f} s; K1 launches {fleet_launches}")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rows = phase_rows_moe(torch, burnin, serve, decode, moe, prng, weights, quant, pa,
                              greedy_done, greedy_line)
        del greedy_done
        gc.collect()
        torch.cuda.empty_cache()
        phase_moe_train(torch, burnin, models)
        phase_families(models)
        log(f"phase rows and MoE: {time.perf_counter() - t:.3f} s; K1 launches {rows}")
        # The rows layout has no block table: K1, either form, never runs there.
        paged_row["launches_by_path"].update(rows)
        int8_row["launches_by_path"].update(rows)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        mesh_serving = phase_sharded_serving(torch, validate, gather_tokens, int8_gather_tokens,
                                             disagg_tokens)
        del gather_tokens, int8_gather_tokens, disagg_tokens
        log(f"phase sharded serving: {time.perf_counter() - t:.3f} s; K1 and K2 launches "
            f"{mesh_serving}")
        paged_row["launches_by_path"].update(mesh_serving)
        int8_row["launches_by_path"].update(mesh_serving)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        flash_row["launches"], train_p50, train_losses, train_peak = phase_train(
            torch, burnin, mfu, fa, flash)
        log(f"phase train: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        sharded_row, sharded_launches = phase_sharded(torch, fa, flash, mfu, validate,
                                                      train_losses, train_p50)
        log(f"phase sharded training: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        flash_row["ulysses_view_p2"], ulysses_launches = phase_long_context(
            torch, fa, flash, mfu, models, spmd, validate, train_losses, train_p50, train_peak,
            sharded_row["ms"])
        log(f"phase long-context training: {time.perf_counter() - t:.3f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        flash_row["launches_by_path"] = {
            "train": flash_row["launches"],
            "sharded train": sharded_launches,
            "ulysses train": ulysses_launches,
            **mesh_serving,
            **phase_burnin(torch, burnin, mfu, fa, data, ckpt, prng, validate, train_p50),
        }
        log(f"phase burn-in: {time.perf_counter() - t:.3f} s; flash launches "
            f"{flash_row['launches_by_path']}")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        pipe = phase_pipeline(torch, ckpt, validate)
        flash_row["launches_by_path"].update(pipe["k2"])
        sharded_row["launches_by_path"] = {"sharded train": sharded_launches,
                                           "mesh train_on_stream": pipe["k2"]["mesh train_on_stream"],
                                           "pipelined train": pipe["k2"]["pipelined train"]}
        paged_row["launches_by_path"].update(pipe["k1"])
        int8_row["launches_by_path"].update(pipe["k1"])
        log(f"phase pipeline and mesh payload: {time.perf_counter() - t:.3f} s; K1 launches "
            f"{pipe['k1']}, K2 launches {pipe['k2']}")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        k3_row = phase_moonlight(torch, serve, mla_moe, k3)
        log(f"phase Moonlight: {time.perf_counter() - t:.3f} s; K3 launches {k3_row['launches']}")
        log(f"all phases: {time.perf_counter() - started:.3f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [paged_row, flash_row, sharded_row, int8_row, k3_row]}))
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
