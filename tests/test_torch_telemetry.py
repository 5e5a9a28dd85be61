"""The port's serving telemetry (tpu_dra_torch/parallel/serve.py and
disagg.py over tpu_dra_torch/utils/{metrics,trace,servestats}.py and
tpu_dra_torch/obs/{kv,requests,capacity}.py) against the reference's
(tpu_dra/parallel/serve.py, disagg.py over tpu_dra/utils and tpu_dra/obs)
on the reference's weights, at the tiny config of the KV-hierarchy tests.

The two engines (the reference's on the gather backend, its admission
prefill waited for: test_torch_prefix.settled) serve one stream tick by
tick, each writing its own package's registries under the same engine
name.  Scenarios: paged with the prefix cache and the swap tier (a
seeded priority churn: hits, trims, COW, preemptions; both sides pick
victims with the deterministic `LowestPriority`), the rows layout with
its prefix cache, fused ticks (wasted steps), and the disaggregated
server in both handoff modes.  The SLO targets are the deterministic ones
of tests/test_serve_obs.py (a TTFT target of an hour, always met; a TPOT
target of a nanosecond, always missed).  Held equal:

- every `StepRecord` integer field, tick for tick;
- `request_class_stats()` and `kv_snapshot()` (every field but the
  blocks' ``age_s``: refcounts, origins, birth and last-touch steps,
  owners) after every tick;
- each request's spans: names, parent links, and every attribute that is
  not a time;
- SLO verdicts, and every counter's delta for each label set (prefill
  tokens, prefix hits, misses and evictions, alias, COW, swaps, wasted
  steps, SLO verdicts, handoffs), and the observation counts of the
  histograms whose observations are events (TTFT, TPOT, queue wait,
  block age; the free-run histogram bucket for bucket);
- the capacity split: ticks equal, and busy + idle equal to the summed
  step wall of the engine's own records (within 1e-9 relative);
- the gauge series and obs providers an engine registers; `close()`
  retires all of them.

Then the port alone: ``telemetry=False`` records no span and no step;
`profile_steps` writes a Chrome trace on the CPU and disarms after its
``n`` device calls; ``trace_parent`` must be the port's TraceContext,
with the reference's error; the profiler ranges (`trace.range`) of the
engine's phases, the model's attention and expert layer and the
trainer's phases; the trainer's phase histogram, its CUDA event sets
driven through fakes; and the ``serve.admit`` span's TTFT split."""

import contextlib
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from test_disagg import STREAM as DISAGG_STREAM
from test_torch_prefix import dense, settled  # noqa: F401
from test_torch_swap import LowestPriority
from tpu_dra.obs import capacity as jcap
from tpu_dra.obs import kv as jkv
from tpu_dra.obs import requests as jreq
from tpu_dra.parallel.disagg import DisaggServer as JaxServer
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra.utils import metrics as jmetrics
from tpu_dra.utils import servestats as jstats
from tpu_dra.utils import trace as jtrace
from tpu_dra_torch.obs import capacity as tcap
from tpu_dra_torch.obs import kv as tkv
from tpu_dra_torch.obs import requests as treq
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel.disagg import DisaggServer
from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.utils import metrics as tmetrics
from tpu_dra_torch.utils import servestats as tstats
from tpu_dra_torch.utils import trace as ttrace

torch.set_num_threads(2)

SLO = dict(ttft_slo_s=3600.0, tpot_slo_s=1e-9)
INT_FIELDS = ("occupancy", "slots", "queue_depth", "admitted", "prefix_hits", "finished",
              "tokens", "preempted", "swapped_in", "slo_met", "slo_missed")
COUNTERS = ("SERVE_PREFILL_TOKENS", "SERVE_PREFIX_HITS", "SERVE_PREFIX_MISSES",
            "SERVE_PREFIX_EVICTIONS", "SERVE_KV_ALIAS", "SERVE_KV_COW", "SERVE_KV_SWAPS",
            "SERVE_WASTED_STEPS", "SERVE_SLO_TOTAL", "DISAGG_HANDOFFS", "DISAGG_HANDOFF_BLOCKS")
# Histograms whose observations are events, not timed values.
EVENT_HISTOGRAMS = ("SERVE_TTFT_SECONDS", "SERVE_TPOT_SECONDS", "SERVE_QUEUE_WAIT_SECONDS",
                    "SERVE_KV_BLOCK_AGE_SECONDS")
# Span attributes that are times (the last two, the TTFT split on
# serve.admit, are the port's alone).
TIMED = ("queue_wait_s", "ttft_s", "tpot_s", "parked_s", "prefill_s", "wave_wait_s")
GAUGES = ("SERVE_QUEUE_DEPTH", "SERVE_BATCH_OCCUPANCY", "SERVE_TIER_ENGINES", "SERVE_KV_BLOCKS")


def _churn(vocab):
    """test_torch_swap's seeded priority churn (seed 0): one arrival a
    tick, priorities 0, 1, 2 in turn, prompts from two families."""
    rng = np.random.RandomState(0)
    fams = [[int(t) for t in rng.randint(0, vocab, 4)] for _ in range(2)]
    return [(fams[i % 2][:rng.randint(2, 5)]
             + [int(t) for t in rng.randint(0, vocab, rng.randint(1, 4))],
             2 + i % 3, i % 3, i) for i in range(12)]


SHARED = [5, 9, 2, 7]
SCENARIOS = {
    "paged_prefix_swap": (
        dict(slots=2, prompt_slots=8, max_new_cap=4, prefix_window=2, prefix_cache_slots=2,
             kv_blocks=10, swap=True),
        "churn"),
    "rows_prefix": (
        dict(slots=2, prompt_slots=8, max_new_cap=4, prefix_window=2, prefix_cache_slots=4,
             kv_layout="rows"),
        [(SHARED + [t], 3, 0, 0) for t in range(1, 6)]),
    "fused_ticks": (
        dict(slots=3, prompt_slots=8, max_new_cap=5, prefix_window=2, scheduling="tick",
             steps_per_tick=3),
        [([1, 2, 3], 2, 0, 0), ([4, 5], 5, 0, 0), ([6, 7, 8, 9], 4, 0, 0), ([3, 3], 1, 0, 1),
         ([2, 8, 1], 3, 0, 2)]),
}


# -- reading the registries -------------------------------------------------
def _counters(metrics):
    out = {}
    for name in COUNTERS:
        c = getattr(metrics, name)
        with c._lock:
            out[name] = dict(c._values)
    for name in EVENT_HISTOGRAMS + ("SERVE_KV_FREE_RUN_BLOCKS",):
        h = getattr(metrics, name)
        with h._lock:
            out[name] = {k: list(v) for k, v in h._counts.items()}
    return out


def _delta(before, after):
    out = {}
    for name, series in after.items():
        old = before.get(name, {})
        moved = {}
        for key, v in series.items():
            if name in EVENT_HISTOGRAMS:
                d = sum(v) - sum(old.get(key, [0]))
            elif isinstance(v, list):
                d = [a - b for a, b in zip(v, old.get(key, [0] * len(v)))]
                d = d if any(d) else 0
            else:
                d = v - old.get(key, 0.0)
            if d:
                moved[key] = d
        out[name] = moved
    return out


def _gauge_series(metrics, name):
    """The gauge series that carry engine ``name``."""
    out = {}
    for fam in GAUGES:
        g = getattr(metrics, fam)
        with g._lock:
            out[fam] = sorted(k for k in set(g._fns) | set(g._values)
                              if ("engine", name) in k)
    return out


def _providers(kv, req, cap, name):
    return [name in kv.providers(), name in req.providers(), name in cap.providers()]


def _kv_view(snap):
    if snap is None:
        return None
    snap = dict(snap)
    snap["blocks"] = [{k: v for k, v in b.items() if k != "age_s"} for b in snap["blocks"]]
    return snap


def _steps(stats, name):
    return [{f: getattr(r, f) for f in INT_FIELDS} for r in stats.RECORDER.query(engine=name)]


def _span_view(trace_mod, req):
    """A request's spans as (name, parent's name, non-time attributes),
    sorted; the parent of the root is the submitting tier's span or ""."""
    spans = trace_mod.EXPORTER.spans(trace_id=req.trace_id)
    by_id = {s["span_id"]: s["name"] for s in spans}
    assert all(s["trace_id"] == req.trace_id for s in spans)
    return sorted(
        (s["name"], by_id.get(s["parent_id"], "" if not s["parent_id"] else "outside"),
         sorted((k, v) for k, v in s["attributes"].items() if k not in TIMED))
        for s in spans)


# -- one scenario through both engines ---------------------------------------
def _run(dense, case):
    jcfg, tcfg, jparams, tparams = dense
    kw, reqs = SCENARIOS[case]
    kw = dict(kw)
    if kw.pop("swap", False):
        kw["swap_policy"] = LowestPriority()
    if reqs == "churn":
        reqs = _churn(jcfg.vocab)
    name = f"tele-{case}"
    jkw = dict(kw, attn_backend="gather") if kw.get("kv_layout") != "rows" else dict(kw)
    jeng = JaxEngine(jparams, jcfg, name=name, **SLO, **jkw)
    if jeng.kv_layout == "paged":
        settled(jeng)
    before = (_counters(jmetrics), _counters(tmetrics))
    teng = ServeEngine(tparams, tcfg, name=name, device="cpu", **SLO, **kw)
    series = (_gauge_series(jmetrics, name), _gauge_series(tmetrics, name))
    jids, tids, views = [None] * len(reqs), [None] * len(reqs), []
    for tick in range(400):
        for i, (p, b, pr, at) in enumerate(reqs):
            if at == tick:
                jids[i] = jeng.submit(p, b, priority=pr)
                tids[i] = teng.submit(p, b, priority=pr)
        if tick > max(r[3] for r in reqs) and not (jeng.pending or teng.pending):
            break
        jeng.tick()
        teng.tick()
        views.append(((teng.request_class_stats(), _kv_view(teng.kv_snapshot())),
                      (jeng.request_class_stats(), _kv_view(jeng.kv_snapshot()))))
    assert not (jeng.pending or teng.pending)
    after = (_counters(jmetrics), _counters(tmetrics))
    run = dict(
        name=name, jeng=jeng, teng=teng, views=views, series=series,
        jreqs=[jeng.request(i) for i in jids], treqs=[teng.request(i) for i in tids],
        deltas=(_delta(before[0], after[0]), _delta(before[1], after[1])),
        steps=(_steps(jstats, name), _steps(tstats, name)),
        walls=(sum(r.step_wall_s for r in jstats.RECORDER.query(engine=name)),
               sum(r.step_wall_s for r in tstats.RECORDER.query(engine=name))),
        caps=(jeng.capacity_snapshot(), teng.capacity_snapshot()),
        providers=(_providers(jkv, jreq, jcap, name), _providers(tkv, treq, tcap, name)),
    )
    jeng.close()
    teng.close()
    run["closed"] = (_gauge_series(jmetrics, name), _gauge_series(tmetrics, name),
                     _providers(jkv, jreq, jcap, name), _providers(tkv, treq, tcap, name))
    return run


@pytest.fixture(scope="module")
def runs(dense):
    return {case: _run(dense, case) for case in SCENARIOS}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
class TestAgainstTheReference:
    def test_step_records_tick_for_tick(self, runs, case):
        jsteps, tsteps = runs[case]["steps"]
        assert len(tsteps) == len(runs[case]["views"]) > 0
        assert tsteps == jsteps
        assert sum(s["finished"] for s in tsteps) == len(runs[case]["treqs"])
        assert sum(s["tokens"] for s in tsteps) == sum(len(r.tokens) for r in runs[case]["treqs"])
        if case == "paged_prefix_swap":
            assert sum(s["preempted"] for s in tsteps) > 0
            assert sum(s["prefix_hits"] for s in tsteps) > 0

    def test_class_stats_and_kv_snapshot_every_tick(self, runs, case):
        for got, want in runs[case]["views"]:
            assert got == want

    def test_spans(self, runs, case):
        for t, j in zip(runs[case]["treqs"], runs[case]["jreqs"]):
            assert t.trace_id and t.trace_id != j.trace_id
            got, want = _span_view(ttrace, t), _span_view(jtrace, j)
            assert got == want
            names = [s[0] for s in got]
            assert {"serve.queue", "serve.admit", "serve.decode", "serve.request"} <= set(names)
            assert all(parent == ("serve.request" if n != "serve.request" else "")
                       for n, parent, _ in got)

    def test_slo_verdicts_and_counter_deltas(self, runs, case):
        for t, j in zip(runs[case]["treqs"], runs[case]["jreqs"]):
            # A one-token request has no TPOT to miss.
            want = ({"ttft": "met", "tpot": "missed", "request": "missed"} if len(t.tokens) > 1
                    else {"ttft": "met", "request": "met"})
            assert t.slo == j.slo == want
        jdelta, tdelta = runs[case]["deltas"]
        assert tdelta == jdelta
        assert tdelta["SERVE_SLO_TOTAL"][(("slo", "request"), ("verdict", "missed"))] == sum(
            len(t.tokens) > 1 for t in runs[case]["treqs"])
        if case == "fused_ticks":
            assert tdelta["SERVE_WASTED_STEPS"]
        if case == "paged_prefix_swap":
            for fam in ("SERVE_KV_ALIAS", "SERVE_KV_COW", "SERVE_KV_SWAPS", "SERVE_PREFIX_HITS",
                        "SERVE_PREFIX_EVICTIONS", "SERVE_KV_BLOCK_AGE_SECONDS"):
                assert tdelta[fam], fam

    def test_capacity_split(self, runs, case):
        jcap_, tcap_ = runs[case]["caps"]
        assert tcap_["steps"] == jcap_["steps"] == len(runs[case]["views"])
        for snap, wall in zip(runs[case]["caps"], runs[case]["walls"]):
            assert snap["busy_s"] + snap["idle_s"] == pytest.approx(wall, rel=1e-9)

    def test_registrations_and_close(self, runs, case):
        jseries, tseries = runs[case]["series"]
        assert tseries == jseries
        assert tseries["SERVE_QUEUE_DEPTH"]
        jprov, tprov = runs[case]["providers"]
        assert tprov == jprov
        jgone, tgone, jprov_after, tprov_after = runs[case]["closed"]
        assert tgone == jgone and not any(tgone.values())
        assert tprov_after == jprov_after == [False, False, False]


# -- the disaggregated server ------------------------------------------------
@pytest.fixture(scope="module")
def disagg_runs(dense):
    jcfg, tcfg, jparams, tparams = dense
    spec = dict(slots=2, prompt_slots=8, max_new_cap=5, prefix_window=2)
    out = {}
    for mode in ("alias", "dma"):
        name = f"tele-disagg-{mode}"
        jsrv = JaxServer(jparams, jcfg, prefill=dict(spec, attn_backend="gather"),
                         decode=dict(spec, slots=4, attn_backend="gather"), handoff=mode,
                         name=name)
        for eng in jsrv.tiers.values():
            settled(eng)
        before = (_counters(jmetrics), _counters(tmetrics))
        tsrv = DisaggServer(tparams, tcfg, prefill=dict(spec, device="cpu"),
                            decode=dict(spec, slots=4, device="cpu"), handoff=mode, name=name)
        depth = [(jmetrics.DISAGG_PREFILL_QUEUE_DEPTH, jsrv),
                 (tmetrics.DISAGG_PREFILL_QUEUE_DEPTH, tsrv)]
        gauges = [f"server=\"{name}\"" in g.collect() for g, _ in depth]
        jids = [jsrv.submit(p, m, priority=pr) for p, m, pr in DISAGG_STREAM]
        tids = [tsrv.submit(p, m, priority=pr) for p, m, pr in DISAGG_STREAM]
        while jsrv.pending or tsrv.pending:
            jsrv.tick()
            tsrv.tick()
        after = (_counters(jmetrics), _counters(tmetrics))
        run = dict(
            jreqs=[jsrv.result(d) for d in jids], treqs=[tsrv.result(d) for d in tids],
            deltas=(_delta(before[0], after[0]), _delta(before[1], after[1])),
            steps={tier: (_steps(jstats, f"{name}-{tier}"), _steps(tstats, f"{name}-{tier}"))
                   for tier in ("prefill", "decode")},
            gauges=gauges)
        jsrv.close()
        tsrv.close()
        run["gauges_after"] = [f"server=\"{name}\"" in g.collect() for g, _ in depth]
        out[mode] = run
    return out


@pytest.mark.parametrize("mode", ["alias", "dma"])
def test_disagg_telemetry_matches_the_reference(disagg_runs, mode):
    run = disagg_runs[mode]
    for tier in ("prefill", "decode"):
        jsteps, tsteps = run["steps"][tier]
        assert tsteps == jsteps and tsteps, tier
    for t, j in zip(run["treqs"], run["jreqs"]):
        got, want = _span_view(ttrace, t), _span_view(jtrace, j)
        assert got == want
        names = [s[0] for s in got]
        assert names.count("fleet.route") == 1
        if len(t.tokens) > 1:
            assert f"handoff.{mode}" in names and "prefill.run" in names
    jdelta, tdelta = run["deltas"]
    assert tdelta == jdelta
    assert tdelta["DISAGG_HANDOFFS"]
    assert run["gauges"] == [True, True] and run["gauges_after"] == [False, False]


# -- the port alone -------------------------------------------------------------
def _port_engine(dense, **kw):
    _, tcfg, _, tparams = dense
    return ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=4, prefix_window=2,
                       device="cpu", **kw)


def test_telemetry_off_records_no_span_and_no_step(dense):
    eng = _port_engine(dense, telemetry=False, name="tele-off")
    spans, steps = ttrace.EXPORTER.recorded, tstats.RECORDER.recorded
    tpot = sum(sum(v) for v in tmetrics.SERVE_TPOT_SECONDS._counts.values())
    ttft = sum(sum(v) for v in tmetrics.SERVE_TTFT_SECONDS._counts.values())
    for p in ([1, 2, 3], [4, 5, 6, 7], [8, 9]):
        eng.submit(p, 3)
    done = eng.run()
    assert (ttrace.EXPORTER.recorded, tstats.RECORDER.recorded) == (spans, steps)
    assert sum(sum(v) for v in tmetrics.SERVE_TPOT_SECONDS._counts.values()) == tpot
    # The per-request summaries stay on, as the reference's.
    assert sum(sum(v) for v in tmetrics.SERVE_TTFT_SECONDS._counts.values()) == ttft + 3
    snap = eng.capacity_snapshot()
    assert snap["steps"] > 0 and snap["busy_s"] + snap["idle_s"] > 0
    assert len(done) == 3 and all(r.trace_id for r in done)
    eng.close()


def test_profile_steps_writes_a_trace_and_disarms(dense, tmp_path):
    eng = _port_engine(dense, name="tele-profile")
    with pytest.raises(ValueError, match="n >= 1"):
        eng.profile_steps(0)
    got = eng.profile_steps(2, str(tmp_path))
    assert got == str(tmp_path) and eng.profiling
    with pytest.raises(RuntimeError, match="already armed"):
        eng.profile_steps(1)
    eng.submit([1, 2, 3], 4)
    eng.tick()  # the admission and the first device call
    assert eng.profiling
    eng.tick()  # the second device call: the capture stops
    assert not eng.profiling and eng.profile_error == ""
    with open(eng.profile_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    eng.run()
    assert not eng.profiling
    eng.close()


def test_trace_parent_must_be_the_ports_context(dense):
    jcfg, _, jparams, _ = dense
    eng = _port_engine(dense, name="tele-parent")
    jeng = JaxEngine(jparams, jcfg, slots=1, prompt_slots=8, max_new_cap=2,
                     attn_backend="gather", name="tele-parent-ref")
    with pytest.raises(ValueError) as got:
        eng.submit([1, 2], 2, trace_parent="00-abc")
    with pytest.raises(ValueError) as want:
        jeng.submit([1, 2], 2, trace_parent="00-abc")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):  # the reference's context is not the port's
        eng.submit([1, 2], 2, trace_parent=jtrace.TraceContext.new())
    parent = ttrace.TraceContext.new()
    rid = eng.submit([1, 2], 2, trace_parent=parent)
    eng.run()
    req = eng.request(rid)
    assert req.trace_id == parent.trace_id
    root = next(s for s in ttrace.EXPORTER.spans(trace_id=parent.trace_id)
                if s["name"] == "serve.request")
    assert root["parent_id"] == parent.span_id and root["span_id"] == req.trace_ctx.span_id
    eng.close()
    jeng.close()


# -- profiler ranges -------------------------------------------------------------
PHASE_RANGES = ("engine.admit", "engine.dispatch", "engine.fetch", "engine.host")
MOE_RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(scope="module")
def moe(dense):
    _, tcfg, _, _ = dense
    cfg = dataclasses.replace(tcfg, moe_experts=4)
    return cfg, tb.init_params(cfg, device="cpu")


def _profiled(fn, tmp_path):
    """Run ``fn`` under `torch.profiler` (CPU activity) and return its
    Chrome trace's ``user_annotation`` events as (name, start_us, end_us)
    in start order, with ``fn``'s result."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X")
    return sorted(ranges, key=lambda r: r[1]), out


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_range_is_one_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = ttrace.range("engine.tick"), ttrace.range("moe.route")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(ttrace.range("engine.tick"), torch.profiler.record_function)
    assert ttrace.range("engine.tick") is a


# Each engine's profiled tick admits one request through one of the
# three prefill calls: the paged prefill, a rows prefix hit's suffix,
# and the rows B=1 prefill of the MoE model.
RANGE_ENGINES = {
    "paged": dict(kv_layout="paged"),
    "rows_prefix_hit": dict(kv_layout="rows", prefix_cache_slots=2),
    "moe_rows": dict(kv_layout="rows"),
}


@pytest.mark.parametrize("case", sorted(RANGE_ENGINES))
def test_a_tick_marks_its_phases_as_ranges(dense, moe, case, tmp_path):
    _, tcfg, _, tparams = dense
    cfg, params = moe if case == "moe_rows" else (tcfg, tparams)
    name = f"tele-ranges-{case}"
    eng = ServeEngine(params, cfg, slots=2, prompt_slots=8, max_new_cap=4, prefix_window=2,
                      device="cpu", name=name, **RANGE_ENGINES[case])
    if case == "rows_prefix_hit":
        eng.submit([5, 9, 2, 7, 1], 2)
        eng.run()
    rid = eng.submit([5, 9, 2, 7, 3], 3)
    ranges, _ = _profiled(eng.tick, tmp_path)
    record = tstats.RECORDER.query(engine=name)[-1]
    assert (eng.request(rid).prefix_reused > 0) == (case == "rows_prefix_hit")
    by = {}
    for r in ranges:
        by.setdefault(r[0], []).append(r)
    (tick,) = by["engine.tick"]
    (admit,) = by["engine.admit"]
    (prefill,) = by["engine.prefill"]
    assert _inside(admit, tick) and _inside(prefill, admit)
    for phase in PHASE_RANGES[1:]:
        (r,) = by[phase]
        assert _inside(r, tick) and r[1] >= admit[2]
    assert by["engine.dispatch"][0][2] <= by["engine.fetch"][0][1]
    assert by["engine.fetch"][0][2] <= by["engine.host"][0][1]
    for phase in PHASE_RANGES:
        spent = sum(r[2] - r[1] for r in by[phase]) * 1e-6
        want = record.phase_s[phase.split(".")[1]]
        assert abs(spent - want) <= max(0.1 * want, 5e-4), (phase, spent, want)
    assert all(_inside(r, tick) for r in by["decode.attn"])
    eng.close()


@pytest.mark.parametrize("tick", ["admission", "decode"])
def test_moe_ranges_once_per_layer_per_model_call(moe, tick, tmp_path):
    cfg, params = moe
    eng = ServeEngine(params, cfg, slots=2, prompt_slots=8, max_new_cap=4, device="cpu",
                      kv_layout="rows", name=f"tele-moe-{tick}")
    eng.submit([1, 2, 3], 4)
    if tick == "decode":
        eng.tick()
    ranges, _ = _profiled(eng.tick, tmp_path)
    calls = 2 if tick == "admission" else 1  # the B=1 prefill, then the decode step
    names = [r[0] for r in ranges]
    for name in MOE_RANGES + ("decode.attn",):
        assert names.count(name) == cfg.n_layers * calls, name
    # Each layer's parts in order, inside the layer's call.
    parts = [r for r in ranges if r[0] in MOE_RANGES]
    for i in range(0, len(parts), 4):
        assert [r[0] for r in parts[i:i + 4]] == list(MOE_RANGES)
        assert all(a[2] <= b[1] for a, b in zip(parts[i:i + 4], parts[i + 1:i + 4]))
    eng.close()


# -- the trainer's phase times -----------------------------------------------------
def _phase_hist():
    h = tmetrics.TRAIN_PHASE_DEVICE_SECONDS
    with h._lock:
        return {dict(k)["phase"]: (sum(v), h._sums[k]) for k, v in h._counts.items()}


def test_cpu_train_steps_observe_their_phases(dense, tmp_path):
    _, tcfg, _, _ = dense
    step, state = tb.make_train_step(tcfg, device="cpu")
    tokens = tb.prepare_tokens(tcfg, device="cpu")
    before = _phase_hist()
    wall = 0.0
    for i in range(3):
        t0 = time.perf_counter()
        if i < 2:
            state, loss = step(state, tokens)
        else:
            ranges, (state, loss) = _profiled(lambda: step(state, tokens), tmp_path)
        float(loss)
        wall += time.perf_counter() - t0
    after = _phase_hist()
    assert set(after) == set(tb.TRAIN_PHASES)
    for phase in tb.TRAIN_PHASES:
        n = after[phase][0] - before.get(phase, (0, 0.0))[0]
        spent = after[phase][1] - before.get(phase, (0, 0.0))[1]
        assert n in (2, 3) and 0.0 < spent <= wall, phase
    spans = [r for r in ranges if r[0].startswith("train.")]
    assert [r[0] for r in spans] == [f"train.{p}" for p in tb.TRAIN_PHASES]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


class _FakeEvent:
    """A CUDA event's surface as `burnin._PhaseClock` uses it: ``record``
    stamps a fake device clock, ``query`` reads a done flag the test sets."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t, self.done = None, True

    def record(self, stream=None):
        _FakeEvent.clock += 1.0
        self.t, self.done = _FakeEvent.clock, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3  # milliseconds: each phase reads one second


# Per step, whether its events are done at each later step's start: the
# first step is never observed; a set pending at the next step's start is
# read one step later; one still pending two steps on is dropped.
CLOCK_CASES = {
    "done_at_once": ([0, 0, 0, 0, 0], 3),
    "done_one_step_late": ([0, 1, 1, 1, 1], 2),
    "pending_two_steps": ([0, 2, 2, 0, 0], 1),
}


@pytest.mark.parametrize("case", sorted(CLOCK_CASES))
def test_cuda_phase_clock_reads_done_sets_and_drops_stale_ones(monkeypatch, case):
    lags, observed = CLOCK_CASES[case]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    clock = tb._PhaseClock(torch.device("cuda"))
    before = _phase_hist()
    steps = []  # (events, lag) of each step
    for lag in lags:
        for k, (events, left) in enumerate(steps):
            if left == 0:
                events[3].done = True
            steps[k] = (events, left - 1)
        turn = clock._turn
        clock.start()
        clock.mark(1)
        clock.mark(2)
        clock.end()
        steps.append((clock._sets[turn], lag))
    after = _phase_hist()
    for phase in tb.TRAIN_PHASES:
        n = after.get(phase, (0, 0.0))[0] - before.get(phase, (0, 0.0))[0]
        spent = after.get(phase, (0, 0.0))[1] - before.get(phase, (0, 0.0))[1]
        assert n == observed and spent == pytest.approx(observed * 1.0), (phase, n)


# -- the TTFT split on serve.admit -------------------------------------------------
@pytest.mark.parametrize("layout", ["paged", "rows"])
def test_admit_span_splits_the_time_to_first_token(dense, layout):
    eng = _port_engine(dense, kv_layout=layout, name=f"tele-ttft-{layout}")
    ids = [eng.submit(p, 3) for p in ([1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1])]
    eng.run()
    for rid in ids:
        req = eng.request(rid)
        (admit,) = [s for s in ttrace.EXPORTER.spans(trace_id=req.trace_id)
                    if s["name"] == "serve.admit"]
        a = admit["attributes"]
        assert a["prefill_s"] > 0 and a["wave_wait_s"] >= 0
        assert a["prefill_s"] + a["wave_wait_s"] == pytest.approx(admit["duration_s"], abs=1e-3)
        assert req.queue_wait_s + a["prefill_s"] + a["wave_wait_s"] == pytest.approx(
            req.ttft_s, abs=1e-3)
    eng.close()
