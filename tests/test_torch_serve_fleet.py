"""The port's serving fleet (tpu_dra_torch/fleet/{router,stats,fleet}.py,
the ``FLEET_*`` families and ``/debug/fleet`` of
tpu_dra_torch/utils/metrics.py) against the reference's (tpu_dra/fleet,
tpu_dra/utils/metrics.py), the port's fleet over the port's engines and
the reference's over the reference's, on tests/test_fleet.py's config
and weights.

- Router: equal `Placement`s on seeded `ReplicaView` sets under every
  policy (match ties, load skew, goodput penalties, no match, decode
  tiers, the seeded random and round-robin sequences), equal errors.
- Recorder: `summarize`, `render_text` and the records equal; equal
  dropped counts past capacity, the port's under
  ``RING_DROPPED{ring="fleet"}``.
- Fleet, ticked without threads: placements (replica, reason, matched),
  the fleet queue's order with every replica at its cap, a spill under
  ``digest_refresh="manual"`` after an eviction, `scale_hint` verdicts,
  the ``FLEET_*`` counter deltas and gauges equal request by request;
  tokens equal up to a reference near-tie
  (test_torch_prefix.assert_same_tokens).  One drain with the thread
  pool gives the lockstep run's tokens and counts.
- Traces: the ``fleet.route`` root with the engine's ``serve.*`` spans
  under it, and the spill as an event on it, render the reference's
  tree (both trace components pinned: test_torch_obs.same_component).
- Endpoint: the reference's ``python -m tpu_dra.cmds.explain
  fleet-stats`` prints, from the port's ``MetricsServer``, what the
  port's rendering gives and what it prints from the reference's
  server; the JSON documents agree, and a bad query is the reference's
  400."""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_fleet import CFG as JCFG
from test_fleet import PARAMS as JPARAMS
from test_fleet import SYS_A, SYS_B, tail
from test_torch_fleet import TCFG, TPARAMS, _spec, ref_engine
from test_torch_obs import pinned_components, same_component  # noqa: F401
from test_torch_prefix import assert_same_tokens
from tpu_dra.fleet import digest as jdigest
from tpu_dra.fleet import router as jrouter
from tpu_dra.fleet import stats as jstats
from tpu_dra.fleet.fleet import ServeFleet as JaxFleet
from tpu_dra.utils import metrics as jmetrics
from tpu_dra.utils import trace as jtrace
from tpu_dra_torch.fleet import digest as tdigest
from tpu_dra_torch.fleet import router as trouter
from tpu_dra_torch.fleet import stats as tstats
from tpu_dra_torch.fleet.fleet import ServeFleet
from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.utils import metrics as tmetrics
from tpu_dra_torch.utils import trace as ttrace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the router -----------------------------------------------------------------
def _families(rng):
    return [[int(t) for t in rng.randint(0, JCFG.vocab, 24)] for _ in range(4)]


def _view_sets(seed, n_sets):
    """``n_sets`` seeded (prompt, views, knobs) cases, the views as plain
    specs each package builds its own from: digests from the same index
    documents with the same build time, loads from small integers so
    ties are common."""
    rng = np.random.RandomState(seed)
    fams = _families(rng)
    cases = []
    for _ in range(n_sets):
        views = []
        for r in range(rng.randint(1, 6)):
            index = None
            if rng.rand() > 0.2:
                runs = []
                for _ in range(rng.randint(0, 4)):
                    fam = fams[rng.randint(len(fams))]
                    extra = [int(t) for t in rng.randint(0, JCFG.vocab, rng.randint(0, 9))]
                    runs.append({"tokens": fam[:8 * rng.randint(1, 4)] + extra,
                                 "hits": int(rng.randint(1, 4))})
                index = {"prefix_window": 8, "entries": runs, "age": float(rng.randint(0, 5))}
            slots = int(rng.choice([1, 2, 4]))
            views.append(dict(name=f"r{r}", index=index, queue_depth=int(rng.randint(0, 5)),
                              occupancy=int(rng.randint(0, slots + 1)), slots=slots,
                              goodput=[None, 0.5, 0.8, 1.0][rng.randint(4)],
                              tier=["mono", "mono", "mono", "prefill", "decode"][rng.randint(5)]))
        if rng.rand() < 0.8:
            fam = fams[rng.randint(len(fams))]
            prompt = fam[:8 * rng.randint(1, 4)] + [int(t) for t in rng.randint(0, 64, 5)]
        else:
            prompt = [int(t) for t in rng.randint(0, JCFG.vocab, rng.randint(2, 30))]
        cases.append((prompt, views))
    return cases


def _build_views(mod, dmod, specs, now):
    views = []
    for s in specs:
        digest = None
        if s["index"] is not None:
            digest = dmod.build_digest(s["index"], replica=s["name"], epoch=3)
            digest.built_at = now - s["index"]["age"]
        views.append(mod.ReplicaView(name=s["name"], digest=digest, queue_depth=s["queue_depth"],
                                     occupancy=s["occupancy"], slots=s["slots"],
                                     goodput=s["goodput"], tier=s["tier"]))
    return views


def _route(router, mod, dmod, prompt, specs, now):
    try:
        p = router.route(prompt, _build_views(mod, dmod, specs, now))
    except ValueError as e:
        return ("error", str(e))
    return dataclasses.asdict(p), p.span_attributes()


class TestRouter:
    @pytest.mark.parametrize("seed,policy,load_skew,goodput_weight", [
        (1, "affinity", 2.0, 1.0), (2, "affinity", 0.0, 2.0), (3, "affinity", 0.5, 0.0),
        (4, "affinity", 10.0, 1.0), (5, "random", 2.0, 1.0), (6, "round_robin", 2.0, 1.0)])
    def test_placements_equal_on_seeded_view_sets(self, monkeypatch, seed, policy, load_skew,
                                                   goodput_weight):
        now = 1000.0
        monkeypatch.setattr(time, "monotonic", lambda: now)  # digest ages, both packages
        kw = dict(policy=policy, load_skew=load_skew, goodput_weight=goodput_weight, seed=11)
        port, ref = trouter.PrefixRouter(**kw), jrouter.PrefixRouter(**kw)
        reasons = {}
        for prompt, specs in _view_sets(seed, 240):
            got = _route(port, trouter, tdigest, prompt, specs, now)
            want = _route(ref, jrouter, jdigest, prompt, specs, now)
            assert got == want, (prompt, specs)
            key = got[1] if got[0] == "error" else got[0]["reason"]
            reasons[key] = reasons.get(key, 0) + 1
        if policy == "affinity":  # every branch met: affinity, load (shed or no match), errors
            assert reasons.get("affinity", 0) > 20 and reasons.get("load", 0) > 20, reasons
            assert any(k.startswith("cannot route") for k in reasons), reasons
        else:
            assert reasons.get(policy, 0) > 150, reasons

    def test_ties_break_alike(self):
        """Equal matches: the hotter entry, then the colder replica, then
        the replica's place; equal loads to the coldest by name."""
        idx = {"prefix_window": 8, "entries": [{"tokens": SYS_A, "hits": 2}]}
        hot = {"prefix_window": 8, "entries": [{"tokens": SYS_A, "hits": 5}]}
        cases = [
            [("a", idx, 0), ("b", idx, 0)], [("a", idx, 2), ("b", idx, 0)],
            [("a", idx, 0), ("b", hot, 1)], [("b", None, 0), ("a", None, 0)],
        ]
        for case in cases:
            got = [trouter.PrefixRouter().route(SYS_A + [1], [
                trouter.ReplicaView(n, tdigest.build_digest(i, replica=n) if i else None, q)
                for n, i, q in case])]
            want = [jrouter.PrefixRouter().route(SYS_A + [1], [
                jrouter.ReplicaView(n, jdigest.build_digest(i, replica=n) if i else None, q)
                for n, i, q in case])]
            assert [(p.replica, p.reason, p.matched, p.loads) for p in got] == [
                (p.replica, p.reason, p.matched, p.loads) for p in want]

    @pytest.mark.parametrize("kw,views", [
        ({"policy": "nope"}, None), ({"load_skew": -1}, None), ({}, []),
        ({}, [("d0", "decode")]), ({"policy": "random"}, [])])
    def test_errors_equal(self, kw, views):
        out = []
        for mod in (trouter, jrouter):
            with pytest.raises(ValueError) as err:
                router = mod.PrefixRouter(**kw)
                router.route([1, 2], [mod.ReplicaView(n, tier=t) for n, t in views])
            out.append(str(err.value))
        assert out[0] == out[1]


# -- the recorder ---------------------------------------------------------------
def _records(mod, n):
    return [mod.PlacementRecord(
        seq=i + 1, ts_unix=100.0 + i, fleet=f"f{i % 2}", request=i, replica=f"r{i % 3}",
        reason=("affinity", "load", "spill", "random")[i % 4], matched=8 * (i % 3),
        load=0.25 * i, digest_age_s=0.01 * i, queue_depth=i % 5,
        loads={f"r{j}": 0.5 * ((i + j) % 4) for j in range(3)}, trace_id=f"{i:032x}")
        for i in range(n)]


class TestRecorder:
    def test_summary_text_and_records_equal(self):
        got, want = _records(tstats, 13), _records(jstats, 13)
        assert tstats.summarize(got) == jstats.summarize(want)
        assert tstats.render_text(got) == jstats.render_text(want)
        assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
        for empty in ([], _records(tstats, 1)[:0]):
            assert tstats.summarize(empty) == jstats.summarize(empty)
            assert tstats.render_text(empty) == jstats.render_text(empty)

    def test_drops_equal_past_capacity(self):
        before = tmetrics.RING_DROPPED.value(ring="fleet")
        recs = {}
        for mod in (tstats, jstats):
            rec = mod.FleetFlightRecorder(capacity=5)
            for r in _records(mod, 12):
                r.seq, r.ts_unix = 0, 7.0
                rec.record(r)
            recs[mod] = rec
            assert (rec.dropped, rec.recorded) == (7, 12)
        t, j = recs[tstats], recs[jstats]
        for q in ({}, {"fleet": "f1"}, {"replica": "r2", "limit": 1}, {"reason": "load"}):
            assert [r.to_dict() for r in t.query(**q)] == [r.to_dict() for r in j.query(**q)]
        assert tmetrics.RING_DROPPED.value(ring="fleet") - before == 7
        t.clear()
        assert (t.dropped, t.recorded, t.query()) == (0, 12, [])


# -- the fleet over engines, both packages --------------------------------------
def port_engine(name, **kw):
    return ServeEngine(TPARAMS, TCFG, name=name, device="cpu", **_spec(kw))


SIDES = {"port": (port_engine, ServeFleet, tmetrics, tstats, ttrace),
         "ref": (ref_engine, JaxFleet, jmetrics, jstats, jtrace)}
FAMILY = (SYS_A, SYS_B)


def _counters(metrics):
    """The fleet counters' samples, as text lines."""
    return {line for fam in (metrics.FLEET_ROUTED, metrics.FLEET_ROUTE_TOTAL,
                             metrics.FLEET_SCALE_HINTS)
            for line in fam.collect().splitlines() if not line.startswith("#")}


def _counter_deltas(metrics, before, tag):
    def parse(lines):
        return {k: float(v) for k, v in (line.rsplit(" ", 1) for line in lines)}

    a, b = parse(before), parse(_counters(metrics))
    return {k.replace(tag, "T"): v - a.get(k, 0.0) for k, v in b.items()
            if v != a.get(k, 0.0) and (tag in k or "scale_hints" in k or "route_total" in k)}


def _gauges(metrics, name):
    return [line for fam in (metrics.FLEET_QUEUE_DEPTH, metrics.FLEET_LOAD_SKEW)
            for line in fam.collect().splitlines() if f'"{name}"' in line]


def _placements(stats, fleet, tag):
    return [(r.request, r.replica[len(tag) + 1:], r.reason, r.matched, r.queue_depth, r.loads)
            for r in stats.RECORDER.query(fleet=fleet.name)]


def _stats_of(fleet):
    st = fleet.fleet_stats()
    for row in st["replicas"].values():
        if row["digest"] is not None:
            row["digest"] = {k: v for k, v in row["digest"].items()
                             if k not in ("built_at", "age_s")}
    return st


def _drain_ticking(fleet, out):
    """Tick until drained, reading the fleet queue and a scale hint a tick."""
    while fleet.fleet_stats()["fleet_queue_depth"] or any(
            fleet.engine(n).pending for n in fleet.replicas):
        fleet.tick()
        out["depths"].append(fleet.fleet_stats()["fleet_queue_depth"])
        out["hints"].append(fleet.scale_hint()["hint"])


def _auto_run(side, tag, parallel_ticks=False):
    """Two one-slot replicas, one waiter each, ``digest_refresh="auto"``:
    four arrivals one a tick, then a burst of seven (one of them high
    priority, one barred from the prefix cache) that parks fleet-side."""
    make, Fleet, metrics, stats, trace = SIDES[side]
    before = _counters(metrics)
    fleet = Fleet([make(f"{tag}-{i}", slots=1) for i in range(2)], max_queue_per_replica=1,
                  parallel_ticks=parallel_ticks, name=f"fleet-{tag}")
    out = {"depths": [], "hints": []}
    fids = []
    for i in range(4):
        fids.append(fleet.submit(FAMILY[i % 2] + tail(i), 3))
        fleet.tick()
    for i in range(4, 10):
        fids.append(fleet.submit(FAMILY[i % 2] + tail(i), 3, priority=5 if i == 9 else 0))
    fids.append(fleet.submit(SYS_B + tail(10), 2, use_prefix_cache=False))
    out["burst_depth"] = fleet.fleet_stats()["fleet_queue_depth"]
    out["gauges"] = _gauges(metrics, fleet.name)
    out["hints"].append(fleet.scale_hint()["hint"])
    if parallel_ticks:
        fleet.run()
    else:
        _drain_ticking(fleet, out)
    reqs = [fleet.result(f) for f in fids]
    out.update(
        fids=fids, placements=_placements(stats, fleet, tag), stats=_stats_of(fleet),
        prompts=[r.prompt for r in reqs], tokens=[list(r.tokens) for r in reqs],
        reused=[r.prefix_reused for r in reqs], priorities=[r.priority for r in reqs],
        steps=[fleet.engine(n).device_steps for n in fleet.replicas],
        traces={f: [dict(s) for s in trace.EXPORTER.spans(trace_id=fleet.result(f).trace_id)]
                for f in (fids[2], fids[-1])},
        queue_samples=list(fleet._queue_samples), final_hint=fleet.scale_hint())
    fleet.close()
    out["counters"] = _counter_deltas(metrics, before, tag)
    return out


def _spill_run(side, tag):
    """``digest_refresh="manual"``, one cache entry a replica: a request
    parks SYS_A's prefix on a replica, the digests are refreshed, the
    replica serves SYS_B straight (evicting SYS_A), and the next SYS_A
    request, placed on the stale digest, spills."""
    make, Fleet, metrics, stats, trace = SIDES[side]
    before = _counters(metrics)
    fleet = Fleet([make(f"{tag}-{i}", prefix_cache_slots=1) for i in range(2)],
                  digest_refresh="manual", parallel_ticks=False, name=f"fleet-{tag}")
    first = fleet.submit(SYS_A + tail(20), 3)
    fleet.run()
    fleet.refresh_digests()
    eng = fleet.engine(fleet.result(first).replica)
    eng.submit(SYS_B + tail(21), 2)
    while eng.pending:
        eng.tick()
    peek = eng.peek_prefix(SYS_A + tail(22))
    fid = fleet.submit(SYS_A + tail(22), 3)
    fleet.run()
    reqs = [fleet.result(f) for f in (first, fid)]
    out = dict(
        peek=peek, placements=_placements(stats, fleet, tag), stats=_stats_of(fleet),
        prompts=[r.prompt for r in reqs], tokens=[list(r.tokens) for r in reqs],
        traces={fid: [dict(s) for s in trace.EXPORTER.spans(trace_id=reqs[1].trace_id)]},
        hint=fleet.scale_hint())
    fleet.close()
    out["counters"] = _counter_deltas(metrics, before, tag)
    return out


@pytest.fixture(scope="module")
def runs():
    """Both packages' fleets driven on the same streams, each pair under
    one name (their registries and recorders are separate), spans
    stamped with one component."""
    with pinned_components():
        return {side: {"auto": _auto_run(side, f"tsf-auto-{os.getpid()}"),
                       "spill": _spill_run(side, f"tsf-spill-{os.getpid()}")}
                for side in SIDES}


class TestFleet:
    def test_placements_equal(self, runs):
        for run in ("auto", "spill"):
            got, want = runs["port"][run], runs["ref"][run]
            assert got["placements"] == want["placements"]
            assert got["stats"] == want["stats"]
        reasons = {p[2] for p in runs["port"]["auto"]["placements"]}
        assert reasons == {"affinity", "load"}

    def test_fleet_queue_order_with_every_replica_at_its_cap(self, runs):
        got, want = runs["port"]["auto"], runs["ref"]["auto"]
        assert got["burst_depth"] == 5
        assert (got["depths"], got["queue_samples"], got["gauges"]) == (
            want["depths"], want["queue_samples"], want["gauges"])
        assert 'tpu_dra_fleet_queue_depth{fleet="fleet-tsf-auto' in got["gauges"][0]
        order = [p[0] for p in got["placements"]]
        high = got["fids"][9]
        assert got["priorities"][9] == 5
        lows = [f for f in order if f != high]
        assert lows == sorted(lows) and order.index(high) < order.index(got["fids"][8])

    def test_spill_after_an_eviction_under_manual_refresh(self, runs):
        got, want = runs["port"]["spill"], runs["ref"]["spill"]
        assert got["peek"] == want["peek"] == 0
        assert [p[2] for p in got["placements"]] == ["load", "spill"]
        assert got["stats"]["routed"] == {"load": 1, "spill": 1}

    def test_scale_hints_equal(self, runs):
        got, want = runs["port"]["auto"], runs["ref"]["auto"]
        assert got["hints"] == want["hints"]
        assert {"grow", "hold", "shrink"} <= set(got["hints"])
        assert got["final_hint"] == want["final_hint"]
        assert runs["port"]["spill"]["hint"] == runs["ref"]["spill"]["hint"]

    def test_counter_deltas_equal(self, runs):
        for run in ("auto", "spill"):
            got, want = runs["port"][run]["counters"], runs["ref"][run]["counters"]
            assert got == want and got, run
        routed = runs["port"]["spill"]["counters"]
        assert routed['tpu_dra_fleet_route_total{outcome="spill"}'] == 1.0

    def test_tokens_equal_up_to_near_ties(self, runs):
        for run in ("auto", "spill"):
            got, want = runs["port"][run], runs["ref"][run]
            assert got["prompts"] == want["prompts"]
            assert_same_tokens(JCFG, JPARAMS, got["prompts"], got["tokens"], want["tokens"])
        got, want = runs["port"]["auto"], runs["ref"]["auto"]
        assert got["reused"] == want["reused"] and got["reused"][-1] == 0
        assert sum(n > 0 for n in got["reused"]) >= 6

    def test_route_spans_render_the_references_tree(self, runs, same_component):
        for run in ("auto", "spill"):
            got, want = runs["port"][run]["traces"], runs["ref"][run]["traces"]
            assert list(got) == list(want)
            for k, fid in enumerate(got):
                a, b = _normalized(got[fid], k), _normalized(want[fid], k)
                assert ttrace.render_tree(a) == jtrace.render_tree(b)
                assert ttrace.chrome_trace(a) == jtrace.chrome_trace(b)
                names = sorted(s["name"] for s in a)
                assert names == ["fleet.route", "serve.admit", "serve.decode", "serve.queue",
                                 "serve.request"]
                (root,) = [s for s in got[fid] if not s["parent_id"]]
                assert root["name"] == "fleet.route"
                serve_request = next(s for s in got[fid] if s["name"] == "serve.request")
                assert serve_request["parent_id"] == root["span_id"]
        (spill,) = runs["port"]["spill"]["traces"].values()
        (root,) = [s for s in spill if s["name"] == "fleet.route"]
        (event,) = root["events"]
        assert event["name"] == "spill" and root["attributes"]["outcome"] == "spill"
        assert event["attributes"]["to_replica"] == root["attributes"]["replica"]


ORDER = ["fleet.route", "serve.request", "serve.queue", "serve.admit", "serve.decode"]
# The TTFT split on the port's serve.admit span, which the reference lacks.
PORT_ONLY_ATTRIBUTES = ("prefill_s", "wave_wait_s")


def _normalized(spans, k):
    """One request's spans with the run's own identities and clocks taken
    out: trace and span ids by name, starts in the waterfall's order,
    durations, offsets and second-valued attributes zeroed; the port's
    own attributes (`PORT_ONLY_ATTRIBUTES`) left out."""
    ids = {s["span_id"]: f"{ORDER.index(s['name']):016x}" for s in spans}
    out = []
    for s in spans:
        s = dict(s, trace_id=f"{k:032x}", span_id=ids[s["span_id"]],
                 parent_id=ids.get(s["parent_id"], s["parent_id"]), thread="main",
                 start_unix_s=float(ORDER.index(s["name"])), duration_s=0.0)
        s["attributes"] = {a: 0 if a.endswith("_s") else v for a, v in s["attributes"].items()
                           if a not in PORT_ONLY_ATTRIBUTES}
        s["events"] = [dict(e, offset_s=0.0, attributes={
            a: 0 if a.endswith("_s") else v for a, v in e["attributes"].items()})
            for e in s["events"]]
        out.append(s)
    return out


def test_a_threaded_drain_gives_the_lockstep_tokens_and_counts(runs):
    """The one drain with the thread pool (`tick` fanned out, then
    `_drain_free_running`): placement stays on the fleet's thread, so the
    placements, tokens and device steps are the lockstep run's."""
    threaded = _auto_run("port", f"tsf-threads-{os.getpid()}", parallel_ticks=True)
    lockstep = runs["port"]["auto"]
    assert threaded["tokens"] == lockstep["tokens"]
    assert [p[1:4] for p in threaded["placements"]] == [p[1:4] for p in lockstep["placements"]]
    assert threaded["steps"] == lockstep["steps"]
    assert threaded["stats"]["routed"] == lockstep["stats"]["routed"]


@pytest.mark.parametrize("bad", [
    lambda E: E([]), lambda E: E([types.SimpleNamespace(name="x", slots=1)] * 2),
    lambda E: E([types.SimpleNamespace(name="x", slots=1)], digest_refresh="sometimes"),
    lambda E: E([types.SimpleNamespace(name="x", slots=1)], max_queue_per_replica=0),
    lambda E: E([types.SimpleNamespace(name="x", slots=1)], policy="nope")],
    ids=["empty", "duplicate", "refresh", "cap", "policy"])
def test_fleet_errors_equal(bad):
    out = []
    for Fleet in (ServeFleet, JaxFleet):
        with pytest.raises(ValueError) as err:
            bad(Fleet)
        out.append(str(err.value))
    assert out[0] == out[1]


def test_a_closed_fleet_refuses_work_alike():
    msgs = []
    for side in SIDES:
        make, Fleet = SIDES[side][:2]
        fleet = Fleet([make(f"tsf-close-{os.getpid()}")], name=f"fleet-tsf-close-{os.getpid()}")
        fleet.close()
        fleet.close()
        row = []
        for call in (lambda: fleet.submit(SYS_A, 2), fleet.tick, fleet.scale_hint):
            with pytest.raises(RuntimeError) as err:
                call()
            row.append(str(err.value))
        msgs.append((row, fleet.fleet_stats()["requests"]))
    assert msgs[0] == msgs[1]


# -- /debug/fleet, read by the reference's CLI ----------------------------------
@pytest.fixture(scope="module")
def servers(runs):
    srv = [tmetrics.MetricsServer("127.0.0.1:0"), jmetrics.MetricsServer("127.0.0.1:0")]
    for s in srv:
        s.start()
    yield [f"http://127.0.0.1:{s.port}" for s in srv]
    for s in srv:
        s.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _untimed(text):
    """A rendering without the process's ring positions and digest ages."""
    return [re.sub(r"^ *\d+ ", "", re.sub(r" +[0-9.]+ +(\d+)$", r" - \1", line))
            for line in text.splitlines()]


def test_the_references_cli_reads_the_ports_endpoint(servers, runs):
    name = f"fleet-tsf-auto-{os.getpid()}"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", "tpu_dra.cmds.explain", "fleet-stats",
                               "--endpoint", url, "--fleet", name], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for url in servers]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    got, want = outs[0][0], outs[1][0]
    assert got == tstats.render_text(tstats.RECORDER.query(fleet=name))
    assert _untimed(got) == _untimed(want) and "11 placement(s)" in got
    docs = []
    for url in servers:
        status, body = _get(f"{url}/debug/fleet?fleet={name}")
        assert status == 200
        doc = json.loads(body)
        for row in doc["placements"]:
            row["seq"] = row["ts_unix"] = row["digest_age_s"] = 0
            row["trace_id"] = ""
        doc["recorded"] = doc["dropped"] = 0
        docs.append(doc)
    assert docs[0] == docs[1]
    stats = runs["port"]["auto"]["stats"]
    summary = docs[0]["summary"]
    assert summary["by_reason"] == dict(sorted(stats["routed"].items()))
    assert summary["by_replica"] == {n: r["placements"] for n, r in stats["replicas"].items()}
    for fmt in ("text", "json"):
        status, body = _get(f"{servers[0]}/debug/fleet?format={fmt}&reason=load&limit=2")
        assert status == 200 and body


@pytest.mark.parametrize("query", ["format=xml", "limit=0", "limit=x"])
def test_bad_queries_are_the_references_400s(servers, query):
    codes = []
    for url in servers:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{url}/debug/fleet?{query}")
        codes.append((err.value.code, err.value.read().decode()))
    assert codes[0] == codes[1] and codes[0][0] == 400
