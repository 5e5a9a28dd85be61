"""Fleet driver: ``replicas`` paged `ServeEngine`s, one a card, in a
`ServeFleet` behind the port's prefix-affinity router, under multi-turn
sessions (`sessions`).

Set-up makes each card's weights from the seed (the same tensors on
every card, `weights.make_params`), builds each replica with the cell's
``engine`` settings (its prefix cache on) and the fleet with its
defaults (the replicas' ticks fanned over threads), and serves a few
warm-up requests on each replica.  The window keeps ``depth`` requests
waiting: a session's next turn goes in as soon as its reply has come
back, new sessions fill the rest, and the fleet ticks.  After the
window the fleet drains what it holds, a minute at most.

Read for the per-layer metrics: the window's differences of the fleet's
placements by reason (``fleet_stats()["routed"]``), of the replicas'
prompt tokens computed and reused (``prefix_stats``) and of each
replica's tick phases (``SERVE_STEP_PHASE_SECONDS``), and the device
trace of every card.  The check is `serve`'s: every finished request of
the window, up to the token budget, the same share from each replica,
through the plain reference on the first card.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import devtrace, traffic as tr, weights
from benchmark.drivers import serve as base
from benchmark.harness import Outcome, Run, sync
from benchmark.sessions import SessionGen

WARM_UP = 2


def _check_sample(done_by_replica: "dict[str, list]", seed: int) -> list:
    """Finished requests for the reference, an equal token share from
    each replica (`serve._sample` within each share)."""
    out = []
    share = base.CHECK_TOKENS // max(1, len(done_by_replica))
    for i, name in enumerate(sorted(done_by_replica)):
        picked, toks = [], 0
        for q in base._sample(done_by_replica[name], seed + i):
            if toks >= share:
                break
            picked.append(q)
            toks += len(q.tokens)
        out += picked
    return out


def _reuse(engines) -> "tuple[int, int]":
    stats = [e.prefix_stats for e in engines]
    return (sum(s["prefill_tokens_reused"] for s in stats),
            sum(s["prefill_tokens_computed"] for s in stats))


def run(run: Run) -> Outcome:
    from tpu_dra_torch.fleet import ServeFleet
    from tpu_dra_torch.parallel.serve import ServeEngine

    m = run.model
    n = int(run.cell["replicas"])
    devices = [run.devices[i % len(run.devices)] for i in range(n)]
    params = [weights.make_params(m, run.seed, d) for d in devices]
    run.mark("weights")
    opts = dict(run.cell["engine"])
    if devices[0].type != "cuda" and opts.get("attn_backend") == "cuda":
        opts["attn_backend"] = "gather"
    engines = [ServeEngine(p, base.program_config(m), device=d, name=f"bench-{run.name}-{i}",
                           **opts) for i, (p, d) in enumerate(zip(params, devices))]
    for e in engines:
        base.plant(e, run.fault)
    fleet = ServeFleet(engines)
    run.mark("engine")
    gen = SessionGen(run.traffic, run.seed, m["vocab"], opts["prompt_slots"])
    run.mark("requests")

    # Warm-up on every replica: each shape the window uses, K1 built.
    rng = np.random.default_rng(tr.seed_words(run.seed, 5))
    for e in engines:
        for _ in range(WARM_UP):
            e.submit(rng.integers(0, m["vocab"], opts["prompt_slots"] // 2).tolist(), 4)
        e.run()
    if run.trace:
        devtrace.warm()
    run.setup_done()

    depth = int(run.traffic["arrivals"]["depth"])
    live: "dict[int, tuple]" = {}  # fleet id -> (session, prompt)
    ready: list = []  # sessions whose next turn is due
    sent: list = []  # fleet ids of the window
    refused = 0
    routed0 = dict(fleet.fleet_stats()["routed"])
    reuse0 = _reuse(engines)
    phases0 = {e.name: base._phase_sums(e.name) for e in engines}
    t0 = time.perf_counter()
    end = t0 + run.seconds
    profile_from = end - min(base.PROFILE_S, run.seconds / 3) if run.trace else None
    window = trace = None

    def waiting() -> int:
        return fleet.fleet_stats()["fleet_queue_depth"] + sum(e.queue_depth for e in engines)

    def feed(now: float) -> None:
        nonlocal refused
        while now < end and waiting() < depth:
            s = ready.pop(0) if ready else gen.new()
            turn = s.next_prompt()
            if turn is None:
                continue
            prompt, budget = turn
            try:
                fid = fleet.submit(prompt, budget)
            except ValueError:
                refused += 1
                continue
            live[fid] = (s, prompt)
            sent.append(fid)

    def collect() -> None:
        for fid in list(live):
            q = fleet.result(fid)
            if q is not None and q.done:
                s, prompt = live.pop(fid)
                s.answered(prompt, q.tokens)
                ready.append(s)

    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if profile_from is not None and window is None and now >= profile_from:
            window = devtrace.Window()
            window.start()
        feed(now)
        fleet.tick()
        collect()
    window_s = time.perf_counter() - t0  # the profiler's stop after it is not the window's
    if window is not None:
        trace = window.stop()
    routed1 = dict(fleet.fleet_stats()["routed"])
    reuse1 = _reuse(engines)
    phases = {e.name: {p: s - phases0[e.name].get(p, 0.0)
                       for p, s in base._phase_sums(e.name).items()} for e in engines}
    deadline = time.perf_counter() + base.DRAIN_S
    while live and time.perf_counter() < deadline:
        fleet.tick()
        collect()
    sync(run.devices)
    peak = base.memory_peak(run.devices)

    reqs = [fleet.result(fid) for fid in sent]
    reqs = [q for q in reqs if q is not None]
    tokens_in = sum(t <= end for q in reqs for t in base._token_times(q))
    done = [q for q in reqs if q.done]
    tpot = [(q.finished_at - q.first_token_at) / (len(q.tokens) - 1)
            for q in done if q.finished_at <= end and len(q.tokens) > 1]
    e2e = {"output_tokens_per_s": tokens_in / run.seconds,
           "tpot_p95_ms": tr.percentile(tpot, 95) * 1e3}
    placed = {k: routed1.get(k, 0) - routed0.get(k, 0) for k in routed1}
    layer = {"kind": "fleet", "routed": placed,
             "reuse": {"reused": reuse1[0] - reuse0[0], "computed": reuse1[1] - reuse0[1]},
             "replica_phase_s": phases, "window_s": window_s}

    by_replica: "dict[str, list]" = {e.name: [] for e in engines}
    for q in done:
        by_replica[q.replica].append(q)
    sample = _check_sample(by_replica, run.seed)
    checked = {id(q) for q in sample}
    fleet.close()  # and every replica
    del fleet, engines
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    gaps, margins = base.served_gaps(params[0], m, sample, 0, devices[0])
    checks, readings = base.served_checks(run, gaps, margins)
    readings["requests"] = len(sample)
    readings["window"] = {"finished": sum(q.finished_at <= end for q in done),
                          "tokens": int(tokens_in), "sessions": gen.started,
                          "routed": placed, "reuse": layer["reuse"],
                          "replica_phase_s": phases, "window_s": window_s,
                          "checked_by_replica": {k: sum(id(q) in checked for q in v)
                                                 for k, v in by_replica.items()}}
    return Outcome(attempted=len(sent) + refused,
                   failed=refused + sum(not q.done for q in reqs),
                   e2e=e2e, checks=checks, memory_peak_bytes=peak, layer=layer, trace=trace,
                   readings=readings)
