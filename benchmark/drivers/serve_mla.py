"""Serving driver for a DeepSeek-V3-block model (latent attention, top-k
experts): one paged `ServeEngine` under a closed backlog.

Set-up makes the weights on the card from the seed
(`tpu_dra_torch.models.mla_moe.init_params`), builds the engine with the
cell's ``engine`` settings (its prefill windows captured as CUDA graphs)
and serves a few warm-up requests, which build K3 and warm the one
decode shape and the one prefill shape.  It then runs the closed loop
for one median answer's life in ticks (`steady_ticks`), so that the window
starts from the engine's steady mix of request ages and contexts, not
from an empty engine filling its 128 rows.  The window keeps the backlog
full and ticks the engine, as `serve` does (its `Loop`); its tokens are
those emitted inside it.  A request's time per output token counts its
gaps after the fill (the first ticks admit every row at once, which no
later tick does).  Requests in flight at the window's close are not
drained (one may have 2,048 tokens left, about a minute of decoding).

The check: the plain float32 reference (`reference/mla_moe.py`, TF32
off) reads each sampled request's prompt and served tokens, the served
bf16 weights widened to f32 a matrix at a time, and follows the
program's recorded expert choices (`ServeEngine.request_routes`).  The
sample is drawn from the requests that finished inside the window and
those in flight at its close, whose served prefixes hold the long
positions to the reference; the longest comes first.  Compared:

- ``served_gap_mean``: the mean gap between the reference's best logit
  and the served token's, over the served tokens;
- ``route_mismatches``: the program's choices of an expert layer at a
  position that differ from the reference's own where the reference's
  ``k``-th to ``k+1``-th biased score margin exceeds the cell's
  ``route_margin`` (a margin set from the measured rounding; nearer
  ties may fall either way, and the reference then follows the
  program).

The control (``--variant fp8``, `control.py`) serves weights rounded
through float8 e4m3 (one scale a row), a precision below the served
bf16; the reference reads the bf16 weights, made again from the seed.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import devtrace, traffic as tr
from benchmark.drivers import serve as base
from benchmark.harness import Check, Outcome, Run, sync
from benchmark.reference import mla_moe as ref

WARM_UP = 4


def make_params(cfg: dict, seed: int, device, variant: str = ""):
    from tpu_dra_torch.models.mla_moe import MlaMoeConfig, init_params

    params = init_params(MlaMoeConfig.from_dict(cfg), seed, device)
    if variant == "fp8":
        _round_fp8(params)
    elif variant:
        raise ValueError(f"no variant {variant!r} for this driver")
    return params


def _round_fp8(params) -> None:
    """Every bf16 matrix rounded through float8 e4m3, one scale a row of
    its last dim (its largest magnitude at 448), in place."""
    leaves = [params["embed"], params["lm_head"]]
    leaves += [t for layer in params["layers"] for t in layer.values()
               if t.dtype == torch.bfloat16]
    for t in leaves:
        rows = t.view(-1, t.shape[-1])
        for lo in range(0, rows.shape[0], 1 << 16):
            blk = rows[lo:lo + (1 << 16)].float()
            s = blk.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
            rows[lo:lo + (1 << 16)] = ((blk / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def build_engine(run: Run, params):
    from tpu_dra_torch.models.mla_moe import MlaMoeConfig
    from tpu_dra_torch.parallel.serve import ServeEngine

    opts = dict(run.cell["engine"])
    if run.device.type != "cuda" and opts.get("attn_backend") == "cuda":
        opts["attn_backend"] = "gather"  # the CPU rehearsal reads the latents by gathering
    return ServeEngine(params, MlaMoeConfig.from_dict(run.model), device=run.device,
                       name=f"bench-{run.name}", record_routes=True, **opts)


def served_checks(run: Run, params, reqs: list):
    """The compared numbers over ``reqs`` (each a prompt, its served
    tokens and the routes it was served with), and readings for standard
    error."""
    cfg, dev = run.model, run.device
    margin_at = float(run.cell["route_margin"])
    gaps, compared, checked, mismatches, near, widest = [], 0, 0, 0, 0, 0.0
    with torch.no_grad(), ref.strict_fp32():
        for q in reqs:
            seq = torch.tensor(list(q.prompt) + list(q.tokens[:-1]), dtype=torch.long, device=dev)
            report: list = []
            logits = ref.forward(params, seq, cfg, routes=q.routes, report=report)
            lg = logits[len(q.prompt) - 1:]
            served = torch.tensor(q.tokens, dtype=torch.long, device=dev)
            gaps.append(lg.max(-1).values - lg.gather(-1, served[:, None])[:, 0])
            del logits, lg
            if report:
                own = torch.stack([r["own"] for r in report], 1).sort(-1).values
                margin = torch.stack([r["margin"] for r in report], 1)
                differ = (own != q.routes.long().sort(-1).values).any(-1)
                wide = margin > margin_at
                compared += differ.numel()
                checked += int(wide.sum())
                mismatches += int((differ & wide).sum())
                near += int((differ & ~wide).sum())
                if differ.any():
                    widest = max(widest, float(margin[differ].max()))
    g = torch.cat(gaps).cpu().numpy() if gaps else np.zeros(0)
    values = {"served_gap_mean": float(g.mean()) if g.size else math.inf,
              "route_mismatches": float(mismatches) if g.size else math.inf}
    checks = [Check(name, values[name], limit) for name, limit in run.cell["limits"].items()]
    readings = {**values, "served_gap_max": float(g.max()) if g.size else math.inf,
                "served_tokens": int(g.size), "flips": int((g > 0).sum()),
                "route_choices": compared, "route_choices_checked": checked,
                "route_checked_share": checked / compared if compared else 0.0,
                "route_flips_near_tie": near, "route_flip_widest_margin": widest}
    return checks, readings


def _tally_diff(after, before):
    return [[a - b for a, b in zip(ra, rb)] for ra, rb in zip(after, before)]


def steady_ticks(traffic: dict) -> int:
    """Closed-loop ticks of set-up before the window: the traffic's
    median answer, one token a tick.  After them the window's finishing
    rate and contexts lie within a tenth of a long run's (a renewal
    simulation of moonlight-reason's 128 rows, PERF.md)."""
    out = traffic["output"]
    if out["dist"] == "lognormal":
        return int(out["median"])
    return (int(out["min"]) + int(out["max"])) // 2


def _contexts(reqs) -> dict:
    """Quartiles and the largest of the requests' contexts (prompt and
    served tokens)."""
    ctx = sorted(len(q.prompt) + len(q.tokens) for q in reqs)
    if not ctx:
        return {}
    return {"n": len(ctx), "p25": ctx[len(ctx) // 4], "p50": ctx[len(ctx) // 2],
            "p75": ctx[3 * len(ctx) // 4], "max": ctx[-1]}


def _tpot_after(q, since: float) -> "float | None":
    """The mean gap between ``q``'s tokens emitted after ``since``."""
    times = base._token_times(q)
    after = [t for t in times if t > since]
    if len(after) < 2:
        return None
    return (after[-1] - after[0]) / (len(after) - 1)


def run(run: Run) -> Outcome:
    cfg, dev = run.model, run.device
    params = make_params(cfg, run.seed, dev, run.variant)
    run.mark("weights")
    engine = build_engine(run, params)
    base.plant(engine, run.fault)
    run.mark("engine")
    reqs = tr.requests(run.traffic, run.seconds, run.seed, cfg["vocab_size"])
    run.mark("requests")

    # Warm-up: K3 built, the decode step's one shape and the captured
    # prefill windows run once.
    for r in tr.requests(run.traffic, run.seconds, run.seed + 1, cfg["vocab_size"])[:WARM_UP]:
        engine.submit(list(r.prompt), 4)
    engine.run()
    run.mark("warm-up")
    # The closed loop to its steady state: the rows fill in the first
    # ticks, and the fill ends at the first tick that leaves no row free.
    loop = base.Loop(engine, reqs, run.traffic["arrivals"], detail=run.trace)
    filled_at = None
    for _ in range(steady_ticks(run.traffic)):
        now = time.perf_counter()
        loop.feed(now, now)
        loop.tick(False)
        if filled_at is None and engine.occupancy == engine.slots:
            filled_at = time.perf_counter()
    filled_at = filled_at or time.perf_counter()
    steady = len(loop.ticks)
    loop.ticks.clear()
    run.mark("steady")
    if run.trace:
        devtrace.warm()
    run.setup_done()

    phases0 = base._phase_sums(engine.name)
    tally0 = engine.moe_assignments()
    at_start = _contexts([q for q in loop.live.values() if q.tokens])
    t0 = time.perf_counter()
    end = t0 + run.seconds
    profile_from = end - min(base.PROFILE_S, run.seconds / 3) if run.trace else None
    trace = loop.run(t0, end, profile_from)
    phases1 = base._phase_sums(engine.name)
    tally1 = engine.moe_assignments()
    sync(run.devices)
    peak = base.memory_peak(run.devices)
    stats = engine.prefix_stats

    done = [q for _, q in loop.sent if q.done and t0 < q.finished_at <= end]
    live = [q for q in loop.live.values() if q.tokens and not q.done]
    tokens_in = sum(t0 < t <= end for _, q in loop.sent for t in base._token_times(q))
    tpot = [x for x in (_tpot_after(q, filled_at) for q in done) if x is not None]
    e2e = {"output_tokens_per_s": tokens_in / run.seconds,
           "tpot_p95_ms": tr.percentile(tpot, 95) * 1e3}
    layer = {"kind": "serve", "ticks": loop.ticks,
             "phase_s": {p: phases1.get(p, 0.0) - phases0.get(p, 0.0) for p in phases1},
             "tally": _tally_diff(tally1, tally0)}

    # The reference reads finished requests and the served prefixes of
    # those in flight, each with the routes it was served with.
    sample = [SimpleNamespace(prompt=list(q.prompt), tokens=list(q.tokens),
                              routes=engine.request_routes(q.id), done=q.done)
              for q in base._sample(done + live, run.seed)]
    refused, ticks = loop.refused, len(loop.ticks)
    engine.close()
    del engine, loop
    gc.collect()
    if run.variant:
        # The control served other weights; the reference reads the bf16 ones.
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        params = make_params(cfg, run.seed, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, readings = served_checks(run, params, sample)
    readings["requests"] = len(sample)
    readings["requests_in_flight"] = sum(not q.done for q in sample)
    readings["window"] = {"finished": len(done), "tokens": int(tokens_in),
                          "ticks": ticks, "steady_ticks": steady,
                          "fill_s": filled_at - run.t_process - run.marks["warm-up"],
                          "contexts_at_start": at_start, "contexts_at_close": _contexts(live),
                          "contexts_finished": _contexts(done),
                          "tpot_p50_ms": tr.percentile(tpot, 50) * 1e3,
                          "prefill_windows_graph": stats["prefill_windows_graph"],
                          "prefill_windows_eager": stats["prefill_windows_eager"]}
    # A request in flight at the close is neither finished nor failed.
    return Outcome(attempted=len(done) + refused, failed=refused,
                   e2e=e2e, checks=checks, memory_peak_bytes=peak, layer=layer, trace=trace,
                   readings=readings)
