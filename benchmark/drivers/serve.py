"""Serving driver: one `ServeEngine` under an open loop or a closed backlog.

Set-up makes the weights from the seed, builds the engine with the
cell's ``engine`` settings, and serves a few warm-up requests (which
build the kernels on a checkout's first run and warm every shape the
window uses: the engine's decode step has one batch shape, and its
admission prefill pads every prompt to one shape).  The window offers
the traffic's requests as they fall due (open loop: each timed from
when it was due, so the loop's own lateness counts) or keeps the
backlog full (closed loop), and ticks the engine.  After the window the
engine drains what it holds, a minute at most; the memory peak is read,
the engine is freed, and the plain reference runs once over a sample of
the finished requests, drawn from the seed with the longest among them.

The numbers compared are the gaps by which served tokens' logits lie
below the reference's best at their positions (greedy decoding), the
reference reading each prompt with its served tokens (`served_checks`).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import devtrace, traffic as tr, weights
from benchmark.harness import Check, Outcome, Run, sync
from benchmark.reference import model as ref

DRAIN_S = 60.0
PROFILE_S = 2.0  # the traced run profiles the window's last seconds
CHECK_TOKENS = 16384  # served tokens the reference reads, at most about
REF_ROWS = 8  # requests in one reference forward
# A served token of a model with experts is compared only where every
# layer's top-2 router probabilities lie this far apart in the reference:
# 3-5x the router's bf16 rounding (PERF.md, section 2).
ROUTER_TIE = 0.01


def program_config(m: dict):
    from tpu_dra_torch.parallel.burnin import BurninConfig

    return BurninConfig(vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
                        d_ff=m["d_ff"], n_layers=m["n_layers"], seq=m["seq"], batch=1,
                        moe_experts=m.get("moe_experts", 0),
                        moe_capacity=m.get("moe_capacity", 1.25))


def prefill_capacity(m: dict, prompt_slots: int) -> int:
    """An expert's queue length in an admission prefill: the training
    capacity, clamped to the padded prompt."""
    E = m.get("moe_experts", 0)
    if not E:
        return 0
    return min(prompt_slots, max(1, math.ceil(m["seq"] / E * m.get("moe_capacity", 1.25))))


def build_engine(run: Run, params):
    from tpu_dra_torch.parallel.quant import quantize_params
    from tpu_dra_torch.parallel.serve import ServeEngine

    int8 = run.variant == "int8"
    served = quantize_params(params) if int8 else params
    opts = dict(run.cell["engine"])
    if run.device.type != "cuda" and opts.get("attn_backend") == "cuda":
        opts["attn_backend"] = "gather"  # the CPU rehearsal reads KV by gathering
    return ServeEngine(served, program_config(run.model), kv_int8=int8, device=run.device,
                       name=f"bench-{run.name}", **opts)


def plant(engine, fault: str) -> None:
    """A fault under the timed path (tests and controls only)."""
    if fault == "token":
        pick = engine._sample

        def altered(logits, seeds, positions):
            return (pick(logits, seeds, positions) + 1) % logits.shape[-1]

        engine._sample = altered
    elif fault:
        raise ValueError(f"no fault {fault!r} for a serving cell")


def _phase_sums(name: str) -> "dict[str, float]":
    """The engine's `SERVE_STEP_PHASE_SECONDS` sums by phase, read from
    the registry's scrape text (the flight recorder's ring is shorter
    than a window)."""
    from tpu_dra_torch.utils.metrics import SERVE_STEP_PHASE_SECONDS

    out = {}
    for line in SERVE_STEP_PHASE_SECONDS.collect().splitlines():
        if line.startswith(SERVE_STEP_PHASE_SECONDS.name + "_sum{") and \
                f'engine="{name}"' in line:
            phase = line.split('phase="', 1)[1].split('"', 1)[0]
            out[phase] = float(line.rsplit(" ", 1)[1])
    return out


class Loop:
    """Offers the traffic to the engine and records what it saw."""

    def __init__(self, engine, reqs: "list[tr.Req]", arrivals: dict, detail: bool):
        self.engine = engine
        self.reqs = reqs
        self.closed = arrivals["kind"] == "backlog"
        self.depth = int(arrivals.get("depth", 0))
        self.detail = detail
        self.next = 0
        self.live: "dict[int, object]" = {}  # request id -> Request, not yet finished
        self.sent: "list[tuple[float, object]]" = []  # (due, Request) of the window
        self.refused = 0
        self.ticks: "list[dict]" = []

    def feed(self, t0: float, now: float) -> "float | None":
        """Submit what is due; returns when the next request falls due."""
        eng = self.engine
        while self.next < len(self.reqs):
            r = self.reqs[self.next]
            if self.closed:
                if eng.queue_depth >= self.depth:
                    return None
                due = now
            else:
                due = t0 + r.due_s
                if due > now:
                    return due
            self.next += 1
            try:
                rid = eng.submit(list(r.prompt), r.budget, enqueued_at=due)
            except ValueError:
                self.refused += 1
                continue
            req = eng.request(rid)
            self.live[rid] = req
            self.sent.append((due, req))
        return None

    def tick(self, profiled: bool) -> None:
        before = {rid: len(q.tokens) for rid, q in self.live.items()} if self.detail else None
        with torch.profiler.record_function("bench.tick"):
            a = time.perf_counter()
            finished = self.engine.tick()
            b = time.perf_counter()
        rec = {"start": a, "end": b, "profiled": profiled}
        if self.detail:
            admitted, contexts = [], []
            for rid, q in self.live.items():
                n0, n1 = before[rid], len(q.tokens)
                fresh = n0 == 0 and n1 > 0
                if fresh:
                    admitted.append(len(q.prompt))
                if n1 - n0 - fresh > 0:
                    contexts.append(len(q.prompt) + n1 - 1)
            rec["admitted"], rec["contexts"] = admitted, contexts
        self.ticks.append(rec)
        for q in finished:
            self.live.pop(q.id, None)

    def run(self, t0: float, end: float, profile_from: "float | None"):
        """Tick until ``end``; profile from ``profile_from`` to ``end``."""
        window = None
        trace = None
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if profile_from is not None and window is None and now >= profile_from:
                window = devtrace.Window()
                window.start()
            nxt = self.feed(t0, now)
            if self.engine.pending == 0:
                wake = min(end, nxt if nxt is not None else end)
                with torch.profiler.record_function("bench.wait_for_arrival"):
                    time.sleep(max(0.0, wake - time.perf_counter()))
                continue
            self.tick(window is not None)
        if not self.closed:
            self.feed(t0, end)  # due in the window, though the last tick ran past it
        if window is not None:
            trace = window.stop()
        return trace

    def drain(self, deadline: float) -> None:
        while self.live and time.perf_counter() < deadline:
            self.tick(False)


def _token_times(q) -> "list[float]":
    if not q.tokens:
        return []
    return list(q.first_token_at + np.concatenate([[0.0], np.cumsum(q.token_deltas)]))


def _sample(done: list, seed: int) -> list:
    """Finished requests for the reference: the longest, then the others
    in a seeded order, until `CHECK_TOKENS` served tokens."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].prompt) + len(done[i].tokens))
    rng = np.random.default_rng(tr.seed_words(seed, 4))
    out, toks = [], 0
    for i in [longest] + [int(i) for i in rng.permutation(len(done)) if i != longest]:
        if toks >= CHECK_TOKENS:
            break
        out.append(done[i])
        toks += len(done[i].tokens)
    return out


def served_gaps(params: dict, m: dict, reqs: list, capacity: int, device):
    """For every served token of ``reqs``: the gap between the
    reference's best logit at its position and the served token's, and
    the smallest top-2 router margin of that position over the layers
    (inf without experts).  The reference reads each prompt with its
    served tokens, `REF_ROWS` requests of like length at a time."""
    gaps, margins = [], []
    order = sorted(reqs, key=lambda q: len(q.prompt) + len(q.tokens))
    with torch.no_grad(), ref.strict_fp32():
        for lo in range(0, len(order), REF_ROWS):
            batch = order[lo:lo + REF_ROWS]
            seqs = [list(q.prompt) + list(q.tokens[:-1]) for q in batch]
            width = max(len(s) for s in seqs)
            toks = torch.zeros((len(seqs), width), dtype=torch.long)
            for b, s in enumerate(seqs):
                toks[b, :len(s)] = torch.tensor(s)
            trace: "list" = []
            logits = ref.forward(params, toks.to(device), m["n_heads"], moe_capacity=capacity,
                                 group_len=[len(q.prompt) for q in batch], router_margins=trace)
            marg = torch.stack(trace).amin(0) if trace else None
            for b, q in enumerate(batch):
                lg = logits[b, len(q.prompt) - 1:len(seqs[b])]
                served = torch.tensor(q.tokens, dtype=torch.long, device=device)
                gaps.append(lg.max(-1).values - lg.gather(-1, served[:, None])[:, 0])
                margins.append(marg[b, len(q.prompt) - 1:len(seqs[b])] if marg is not None
                               else torch.full_like(gaps[-1], math.inf))
            del logits
    if not gaps:
        return np.zeros(0), np.zeros(0)
    return torch.cat(gaps).cpu().numpy(), torch.cat(margins).cpu().numpy()


def served_checks(run: Run, gaps: np.ndarray, margins: np.ndarray):
    """The cell's compared numbers, over the served tokens whose every
    router margin clears `ROUTER_TIE` (all tokens of a dense model): ``served_gap_max``, the widest gap, and ``served_gap_mean``,
    the mean gap a served token.  A lower precision moves the mean as
    the square of its error (more tokens flip, each by more), the widest
    gap only as the error; see PERF.md for the readings."""
    kept = gaps[margins >= (ROUTER_TIE if run.model.get("moe_experts") else 0.0)]
    values = {"served_gap_max": float(kept.max()) if kept.size else math.inf,
              "served_gap_mean": float(kept.mean()) if kept.size else math.inf}
    checks = [Check(name, values[name], limit) for name, limit in run.cell["limits"].items()]
    readings = {**values, "served_tokens": int(gaps.size), "checked_tokens": int(kept.size),
                "flips": int((kept > 0).sum())}
    return checks, readings


def memory_peak(devices) -> int:
    return max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)


def run(run: Run) -> Outcome:
    m, dev = run.model, run.device
    params = weights.make_params(m, run.seed, dev)
    run.mark("weights")
    engine = build_engine(run, params)
    plant(engine, run.fault)
    run.mark("engine")
    reqs = tr.requests(run.traffic, run.seconds, run.seed, m["vocab"])
    run.mark("requests")

    # Warm-up: every shape the window uses, the kernels built and loaded.
    for r in tr.requests(run.traffic, run.seconds, run.seed + 1, m["vocab"])[:4]:
        engine.submit(list(r.prompt), min(r.budget, 4))
    engine.run()
    if run.trace:
        devtrace.warm()
    run.setup_done()

    loop = Loop(engine, reqs, run.traffic["arrivals"], detail=run.trace)
    phases0 = _phase_sums(engine.name)
    t0 = time.perf_counter()
    end = t0 + run.seconds
    profile_from = end - min(PROFILE_S, run.seconds / 3) if run.trace else None
    trace = loop.run(t0, end, profile_from)
    phases1 = _phase_sums(engine.name)
    loop.drain(time.perf_counter() + DRAIN_S)
    sync(run.devices)
    peak = memory_peak(run.devices)

    done = [q for _, q in loop.sent if q.done]
    tokens_in = sum(t <= end for _, q in loop.sent for t in _token_times(q))
    tpot = [(q.finished_at - q.first_token_at) / (len(q.tokens) - 1)
            for _, q in loop.sent if q.done and q.finished_at <= end and len(q.tokens) > 1]
    e2e = {
        "output_tokens_per_s": tokens_in / run.seconds,
        "tpot_p95_ms": tr.percentile(tpot, 95) * 1e3,
    }
    layer = {
        "kind": "serve",
        "ticks": loop.ticks,
        "phase_s": {p: phases1.get(p, 0.0) - phases0.get(p, 0.0) for p in phases1},
    }

    sample = _sample(done, run.seed)
    capacity = prefill_capacity(m, run.cell["engine"]["prompt_slots"])
    engine.close()
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps, margins = served_gaps(params, m, sample, capacity, dev)
    checks, readings = served_checks(run, gaps, margins)
    readings["requests"] = len(sample)
    readings["window"] = {"finished": sum(q.finished_at <= end for q in done), "tokens": int(tokens_in),
                          "ticks": len(loop.ticks), "tpot_p50_ms": tr.percentile(tpot, 50) * 1e3}
    return Outcome(attempted=len(loop.sent) + loop.refused,
                   failed=loop.refused + sum(not q.done for _, q in loop.sent),
                   e2e=e2e, checks=checks, memory_peak_bytes=peak, layer=layer, trace=trace,
                   readings=readings)
