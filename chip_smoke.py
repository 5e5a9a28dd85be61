#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpu_dra_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each asserted; any failure exits non-zero and prints no result:

1. card: its name and power limit; bf16 reduced-precision reductions
   and TF32 switched off (the reference never reduces in bf16);
2. build: every CUDA kernel of the package, from the sources in this
   checkout, one ``nvcc`` per source, all started together;
3. kernels: each kernel's wrapper on the card, held against its plain
   PyTorch version at the serving engine's shapes and at one odd small
   shape; masked-tail poisoning must not change the output; the kernel
   and the plain version timed with CUDA events (median of 100 launches,
   L2 flushed between launches) beside the least time the card could
   take;
4. engine: greedy continuous-batching serving of the dense burn-in LM at
   full width (vocab 32768, d_model 4096, 32 heads, d_ff 16384, 8
   layers, seq 1024; random weights from a seeded generator) through
   ``attn_backend="cuda"``: 16 requests through 8 slots, every kernel
   launch counted, then the same stream through the gather backend;
5. the kernels' JSON line, the card's line, and the result line.

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; no network.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

TOL = 2e-2  # kernel vs plain: bf16 outputs, f32 sums in another order
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source


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


def check_kernel(case, plain, kernel, label):
    """Kernel against the plain version (atol = rtol = TOL), then the
    poisoned scratch block and masked tails must leave it bitwise equal."""
    import torch

    q, k_pool, v_pool, table, pos = case
    want = plain(q, k_pool, v_pool, table, pos).float()
    got = kernel(q, k_pool, v_pool, table, pos)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{label}: kernel output not finite")
    err = (got.float() - want).abs().max().item()
    if not torch.allclose(got.float(), want, atol=TOL, rtol=TOL):
        raise AssertionError(f"{label}: kernel vs plain max abs err {err}")
    W = k_pool.shape[1]
    pk, pv = k_pool.clone(), v_pool.clone()
    pk[0], pv[0] = 99.0, -55.0
    for b, p in enumerate(pos.tolist()):
        blk = int(table[b, p // W])
        pk[blk, p % W + 1:], pv[blk, p % W + 1:] = 77.0, 33.0
    poisoned = kernel(q, pk, pv, table, pos)
    torch.cuda.synchronize()
    if not torch.equal(poisoned, got):
        raise AssertionError(f"{label}: masked tail or scratch leaked into the output")
    log(f"kernel {label}: max_abs_err={err} vs plain (tol {TOL}); poisoned tail unchanged")
    return err


def kernel_bound_ms(case):
    """The least time for one call: each input byte read once (K and V
    of the visible positions only, q, the table, pos), the output
    written once, at the HBM rate; or the flops at the bf16 peak."""
    q, k_pool, v_pool, table, pos = case
    B, H, K = q.shape
    W, NW = k_pool.shape[1], table.shape[1]
    visible = sum(min(p + 1, NW * W) for p in pos.tolist())
    nbytes = 2 * visible * H * K * 2 + 2 * B * H * K * 2 + table.numel() * 4 + B * 4
    flops = 4 * visible * H * K
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / H100_BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_kernels(torch, pa):
    engine_pos = [0, 63, 127, 128, 200, 383, 511, 639]  # first, mid, boundary, last slot
    big = make_case(8, 32, 128, 128, 5, 41, engine_pos, seed=1)
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
        "kernel_us": kernel_ms * 1e3,
        "plain_us": plain_ms * 1e3,
        "bound_us": bound_ms * 1e3,
    }


def make_stream(vocab: int):
    import numpy as np

    rng = np.random.RandomState(0)
    stream = []
    for _ in range(16):
        length = int(rng.randint(64, 513))
        stream.append(([int(t) for t in rng.randint(0, vocab, length)], int(rng.randint(16, 65))))
    return stream


def serve(ServeEngine, params, cfg, stream, backend):
    """Drive the stream through one engine tick by tick.  Returns the
    engine, the finished requests by id, the run's wall seconds and the
    wall times of ticks that admitted nothing (one decode step each)."""
    import torch

    eng = ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                      attn_backend=backend)
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


def profile_decode(torch, ServeEngine, params, cfg, steps: int = 8):
    """Where a decode step's device time goes: 8 rows mid-decode (contexts
    256..480 tokens), ``steps`` steps timed on the host clock, then as
    many under torch.profiler.  Kernel time by name comes from the
    exported trace (written to chiprun_out/); the device's idle share is
    one minus kernel time over the unprofiled steps' host wall time."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(params, cfg, slots=8, prompt_slots=512, max_new_cap=64,
                      attn_backend="cuda")
    for i in range(8):
        eng.submit([(7 * i + j) % cfg.vocab for j in range(256 + 32 * i)], 64)
    eng.tick()  # admits all eight, then one step
    eng.tick()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        eng.tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3  # unprofiled: the profiler slows the host
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.tick()
        torch.cuda.synchronize()
    eng.close()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chip_smoke_decode_trace.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    if not kernels:
        log("profile: the trace holds no device kernels; device time not measured")
        return
    by_name: "dict[str, float]" = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    busy_ms = sum(by_name.values()) / 1e3
    log(f"profile, {steps} decode steps of 8 rows: host wall {wall_ms:.3f} ms unprofiled, kernel time "
        f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / steps / 1e3:.4f} ms/step  {us / 1e3 / busy_ms:.4f} of kernel time  {name[:100]}")


def phase_engine(torch, cfg_mod, serve_mod, weights, pa, paged):
    cfg = cfg_mod.BurninConfig(
        vocab=32768, d_model=4096, n_heads=32, d_ff=16384, n_layers=8, seq=1024, batch=16,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = weights.cast_matrices(cfg_mod.init_params(cfg, gen, device="cuda"))
    stream = make_stream(cfg.vocab)

    # Warm-up (cuBLAS handles, the caching allocator) off the record.
    serve(serve_mod.ServeEngine, params, cfg, stream[:2], "cuda")[0].close()

    pa.paged_attention.launches = 0  # count only the main path's launches
    eng, done, wall, steps = serve(serve_mod.ServeEngine, params, cfg, stream, "cuda")
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
    log(f"engine cuda: {len(done)} requests, {n_tok} tokens, {eng.device_steps} steps, "
        f"{launches} kernel launches; {n_tok / wall:.3f} tokens/s, TTFT p50 "
        f"{ttft * 1e3:.3f} ms, step p50 {step_ms:.3f} ms (ticks without admission)")
    eng.close()

    g_eng, g_done, g_wall, g_steps = serve(serve_mod.ServeEngine, params, cfg, stream, "gather")
    g_tok = sum(len(r.tokens) for r in g_done.values())
    log(f"engine gather: {g_tok / g_wall:.3f} tokens/s, step p50 "
        f"{statistics.median(g_steps) * 1e3:.3f} ms")
    g_eng.close()
    profile_decode(torch, serve_mod.ServeEngine, params, cfg)

    # Where greedy tokens first differ, the gather path must have been at
    # a near-tie: its top-2 margin within 2 bf16 ulps of the row's
    # largest logit (2**-6 relative), recomputed by the dense forward.
    diverged = 0
    for rid, r in done.items():
        a, b = r.tokens, g_done[rid].tokens
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        if i is None:
            continue
        diverged += 1
        seq = r.prompt + a[:i]
        toks = torch.zeros((1, cfg.seq), dtype=torch.int32, device="cuda")
        toks[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        with torch.no_grad():
            row = cfg_mod.forward(params, toks, cfg)[0, len(seq) - 1]
        top2 = torch.topk(row, 2).values
        margin = (top2[0] - top2[1]).item()
        tol = 2 ** -6 * row.abs().max().item()
        log(f"request {rid}: tokens differ first at {i} ({a[i]} vs {b[i]}); "
            f"gather-path margin {margin} (near-tie tolerance {tol})")
        if margin > tol:
            raise AssertionError(f"request {rid}: tokens differ at {i} with margin {margin} > {tol}")
    log(f"engine cuda vs gather: {16 - diverged} of 16 requests token-identical, "
        f"{diverged} first differ at a near-tie")

    # One decode step's logits through both backends, on the same state.
    pool = paged.init_block_pool(cfg, 41, 128, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for leaf in pool.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda") * 0.5)
    table = torch.arange(1, 41, dtype=torch.int32, device="cuda").view(8, 5)
    pos = torch.tensor([0, 63, 127, 128, 200, 383, 511, 639], dtype=torch.int32, device="cuda")
    tok = torch.arange(8, dtype=torch.int32, device="cuda") * 1000
    out = {}
    for backend in ("gather", "cuda"):
        with torch.no_grad():
            out[backend], _ = paged.paged_decode_step_rows(
                params, tok, pool, table, pos, cfg, backend=backend
            )
    ref, got = out["gather"], out["cuda"]
    if got.shape != (8, cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"step logits: shape {tuple(got.shape)} or not finite")
    step_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not torch.allclose(got, ref, rtol=2 ** -6, atol=2 ** -6 * scale):
        raise AssertionError(f"step logits cuda vs gather: max abs err {step_err} (scale {scale})")
    log(f"decode step logits cuda vs gather: max abs err {step_err} of max |logit| {scale}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tpu_dra_torch.parallel import burnin, paged, serve, weights
        from tpu_dra_torch.parallel.kernels import _build
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
        row = phase_kernels(torch, pa)
        log(f"phase kernels: {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        row["launches"] = phase_engine(torch, burnin, serve, weights, pa, paged)
        log(f"phase engine: {time.perf_counter() - t:.3f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [row]}))
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
