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
with the reference's error."""

import json

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
# Span attributes that are times.
TIMED = ("queue_wait_s", "ttft_s", "tpot_s", "parked_s")
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
