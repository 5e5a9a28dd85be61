"""The port's telemetry registries and documents
(tpu_dra_torch/utils/{metrics,trace,servestats}.py,
tpu_dra_torch/obs/{kv,requests,capacity}.py) against the reference's
(tpu_dra/utils, tpu_dra/obs) on the same inputs.

- Every metric family the port defines is the reference's family of the
  same name: type, help, labels and buckets; the primitives expose the
  same text for the same observations.
- `servestats.summarize`/`render_text`, `obs.kv.kv_doc`/`render_text`,
  `obs.requests.reduce_request`/`requests_doc`/`render_text`/
  `render_waterfall`, the engines' rows of `obs.capacity.capacity_doc`
  and the trace renderings are equal to the reference's on the same
  records, snapshots and requests (ring sequence numbers, wall stamps and
  process-wide counts aside).  Span comparisons pin both packages'
  trace component (`same_component`), which other tests in the process
  may have moved.
- The port's `MetricsServer` is read by the reference's own CLI
  (``python -m tpu_dra.cmds.explain serve-stats|kv|requests``) as a
  subprocess, which prints what the port's renderings give; every route
  answers, and a bad query is a 400 where the reference's server answers
  400."""

import contextlib
import json
import os
import re
import subprocess
import sys
import types
import urllib.error
import urllib.request

import pytest
import torch

from test_torch_prefix import dense  # noqa: F401
from tpu_dra.obs import capacity as jcap
from tpu_dra.obs import kv as jkv
from tpu_dra.obs import requests as jreq
from tpu_dra.utils import metrics as jmetrics
from tpu_dra.utils import servestats as jstats
from tpu_dra.utils import trace as jtrace
from tpu_dra_torch.obs import capacity as tcap
from tpu_dra_torch.obs import kv as tkv
from tpu_dra_torch.obs import requests as treq
from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.utils import metrics as tmetrics
from tpu_dra_torch.utils import servestats as tstats
from tpu_dra_torch.utils import trace as ttrace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _families(mod):
    return {v.name: v for v in vars(mod).values()
            if isinstance(v, (mod.Counter, mod.Gauge, mod.Histogram))}


# The port's own families, which the reference has no counterpart of.
PORT_ONLY = {"tpu_dra_train_phase_device_seconds"}


class TestFamilies:
    def test_every_family_is_the_references(self):
        ported, ref = _families(tmetrics), _families(jmetrics)
        assert len(ported) == 35 and PORT_ONLY <= set(ported)
        assert not PORT_ONLY & set(ref)
        for name, fam in ported.items():
            if name in PORT_ONLY:
                continue
            want = ref[name]
            assert type(fam).__name__ == type(want).__name__, name
            assert fam.help == want.help, name
            if isinstance(fam, tmetrics.Histogram):
                assert fam.buckets == want.buckets, name
        assert {f.name for f in tmetrics.REGISTRY._metrics} == set(ported)

    @pytest.mark.parametrize("kind", ["Counter", "Gauge", "Histogram"])
    def test_primitives_expose_the_same_text(self, kind):
        def drive(mod):
            if kind == "Histogram":
                m = mod.Histogram("x_seconds", "help", buckets=(0.1, 1.0, 10.0))
                for v, eng in ((0.05, "a"), (2.0, "a"), (50.0, "b"), (1.0, 'q"\n\\')):
                    m.observe(v, engine=eng, phase="admit")
            elif kind == "Counter":
                m = mod.Counter("x_total", "help")
                m.inc(engine="a", mode="alias")
                m.inc(3, engine="b", mode="dma")
            else:
                m = mod.Gauge("x", "help")
                m.set(2, engine="a")
                m.set_function(lambda: 7, engine="b")
                m.set_function(lambda: None, engine="c")
            return m.collect()

        assert drive(tmetrics) == drive(jmetrics)


def _steps():
    rows = []
    for i in range(6):
        rows.append(dict(engine="e1" if i % 2 else "e2", occupancy=i % 3, slots=4,
                         queue_depth=5 - i, admitted=i % 2, prefix_hits=i % 2 * (i > 2),
                         finished=i // 3, preempted=i == 4, swapped_in=i == 5, tokens=3 * i,
                         step_wall_s=0.001 * (i + 1),
                         phase_s={"admit": 1e-4 * i, "dispatch": 2e-4, "fetch": 3e-4 * i,
                                  "host": 5e-5}, slo_met=i, slo_missed=i // 2))
    return rows


@contextlib.contextmanager
def pinned_components(name="tpu-dra"):
    """Both packages' trace modules stamp spans with ``name``, each put
    back afterwards.  Every span carries its module's global component,
    which a reference test that runs the controller's or plugin's main
    in-process sets (tpu_dra/cmds/controller.py, plugin.py); a test that
    compares spans across the two packages must not inherit it."""
    old = jtrace._COMPONENT, ttrace._COMPONENT
    jtrace.set_component(name)
    ttrace.set_component(name)
    try:
        yield
    finally:
        jtrace.set_component(old[0])
        ttrace.set_component(old[1])


@pytest.fixture
def same_component():
    with pinned_components():
        yield


@pytest.fixture
def reference_component_moved():
    """The reference's component as its plugin main leaves it."""
    old = jtrace._COMPONENT
    jtrace.set_component("plugin")
    try:
        yield
    finally:
        jtrace.set_component(old)


def _check_trace_renderings():
    records = []
    for mod in (ttrace, jtrace):
        exp = mod.SpanExporter(capacity=8)
        root = mod.TraceContext("a" * 32, "b" * 16)
        mod.emit_span("serve.request", context=root, exporter=exp, start_unix_s=10.0,
                      duration_s=0.5, request=1)
        mod.emit_span("serve.queue", parent=root, exporter=exp, start_unix_s=10.0,
                      duration_s=0.1, request=1, queue_depth=None)
        spans = exp.spans()
        for s in spans:
            s["span_id"] = "c" * 16 if s["name"] == "serve.queue" else s["span_id"]
            s["thread"] = "main"
        records.append(spans)
    assert records[0] == records[1]
    assert ttrace.render_tree(records[0]) == jtrace.render_tree(records[1])
    assert ttrace.chrome_trace(records[0]) == jtrace.chrome_trace(records[1])
    ctx = ttrace.TraceContext.new()
    assert ttrace.parse_traceparent(ctx.to_traceparent()) == ctx
    assert jtrace.parse_traceparent(ctx.to_traceparent()).to_traceparent() == (
        ctx.to_traceparent())


class TestDocuments:
    def test_servestats_summary_and_text(self):
        jrecs = [jstats.StepRecord(seq=i + 1, **r) for i, r in enumerate(_steps())]
        trecs = [tstats.StepRecord(seq=i + 1, **r) for i, r in enumerate(_steps())]
        assert tstats.summarize(trecs) == jstats.summarize(jrecs)
        assert tstats.render_text(trecs) == jstats.render_text(jrecs)
        assert tstats.render_text([]) == jstats.render_text([])
        assert [r.to_dict() for r in trecs] == [r.to_dict() for r in jrecs]
        assert tstats.PHASES == jstats.PHASES

    def test_kv_doc_and_text(self):
        snap = {"engine": "obs-kv", "block_size": 2, "device_steps": 9, "blocks_total": 8,
                "blocks_free": 3, "blocks_allocated": 4, "blocks_aliased": 1,
                "alias_blocks_total": 5, "cow_blocks_total": 1, "alloc_blocks_total": 9,
                "blocks_host": 2, "host_capacity": 6, "swap_out_blocks_total": 2,
                "swap_in_blocks_total": 0, "preemptions_total": 1, "free_runs": [2, 1],
                "blocks": [{"block": b, "refcount": 1 + (b == 2), "origin": "computed",
                            "birth_step": b, "last_touch_step": b + 1, "idle_steps": 9 - b,
                            "age_s": 0.3 * b, "owners": [f"req:{b}"]} for b in (1, 2, 4, 5)]}
        for mod in (tkv, jkv):
            mod.register("obs-kv", lambda: snap)
        try:
            got, want = tkv.kv_doc(engine="obs-kv", limit=3), jkv.kv_doc(engine="obs-kv", limit=3)
            assert got == want and got["count"] == 1
            assert tkv.render_text(got) == jkv.render_text(want)
            assert tkv.render_text({"engines": []}) == jkv.render_text({"engines": []})
        finally:
            for mod in (tkv, jkv):
                mod.unregister("obs-kv")

    def test_requests_reduction_and_document(self):
        reqs = []
        for i in range(4):
            t0 = 100.0 + i
            reqs.append(types.SimpleNamespace(
                done=True, id=i, replica="obs-req", priority=i % 2, trace_id=f"{i:032x}",
                prompt=[1] * (3 + i), tokens=[2] * (2 + i), finish_reason="budget",
                preemptions=i == 3, enqueued_at=t0, admitted_at=t0 + 0.01 * i,
                first_token_at=t0 + 0.02 * i + 0.005, finished_at=t0 + 0.1 * (i + 1),
                swapped_s=0.02 if i == 3 else 0.0, swap_dma_s=0.005 if i == 3 else 0.0,
                handoff_s=0.01 if i == 2 else 0.0, ttft_s=0.02 * i + 0.005,
                tpot_s=0.01 * i, slo={"request": "met" if i % 2 else "missed"}))
        for r in reqs:
            assert treq.reduce_request(r).to_dict() == jreq.reduce_request(r).to_dict()
        assert treq.reduce_request(types.SimpleNamespace(done=False)) is None
        for r in reqs:
            treq.observe_finished(r)
            jreq.observe_finished(r)
        live = {"engine": "obs-req", "classes": {"0": {"queued": 1, "decoding": 2, "swapped": 0}}}
        for mod in (treq, jreq):
            mod.register("obs-req", lambda: live)
        try:
            got, want = (treq.requests_doc(engine="obs-req"),
                         jreq.requests_doc(engine="obs-req"))
            for doc in (got, want):  # ring positions and wall stamps are the process's
                doc["recorded"] = doc["dropped"] = 0
                for row in doc["requests"]:
                    row["seq"] = row["ts_unix"] = 0
            assert got == want and len(got["requests"]) == 4
            assert treq.render_text(got) == jreq.render_text(want)
            one = treq.requests_doc(engine="obs-req", trace_id=reqs[3].trace_id)
            one_ref = jreq.requests_doc(engine="obs-req", trace_id=reqs[3].trace_id)
            for doc in (one, one_ref):
                doc["requests"][0]["seq"] = doc["recorded"] = doc["dropped"] = 0
            assert treq.render_waterfall(one) == jreq.render_waterfall(one_ref)
        finally:
            for mod in (treq, jreq):
                mod.unregister("obs-req")

    def test_capacity_engine_rows(self):
        snap = {"engine": "obs-cap", "slots": 4, "busy_s": 1.25, "idle_s": 0.75, "steps": 9,
                "last_step_age_s": 0.5}
        for mod in (tcap, jcap):
            mod.register("obs-cap", lambda: snap)
        try:
            got, want = tcap.capacity_doc(), jcap.capacity_doc()
            assert set(got) == set(want)
            pick = [[e for e in d["engines"] if e["engine"] == "obs-cap"] for d in (got, want)]
            assert pick[0] == pick[1] and len(pick[0]) == 1
            assert got["claims"] == [] and got["totals"]["closure"] == 1.0
            assert tcap.render_text(got).splitlines()[-1] == next(
                line for line in jcap.render_text(want).splitlines() if "obs-cap" in line)
        finally:
            for mod in (tcap, jcap):
                mod.unregister("obs-cap")

    def test_trace_renderings(self, same_component):
        _check_trace_renderings()

    def test_trace_renderings_after_the_references_component_moved(
            self, reference_component_moved, same_component):
        """The guard of `same_component`: a reference test that runs a
        plugin main in this process leaves the reference's spans stamped
        ``component="plugin"``; pinned, the renderings still compare."""
        _check_trace_renderings()


# -- the endpoint, read by the reference's CLI ----------------------------------
@pytest.fixture(scope="module")
def server(dense):
    _, tcfg, _, tparams = dense
    eng = ServeEngine(tparams, tcfg, slots=2, prompt_slots=8, max_new_cap=3, prefix_window=2,
                      prefix_cache_slots=2, device="cpu", name="obs-cli")
    for p in ([5, 9, 2, 7, 1], [5, 9, 2, 7, 2], [3, 4]):
        eng.submit(p, 3)
    eng.run()
    srv = tmetrics.MetricsServer("127.0.0.1:0")
    srv.start()
    yield f"http://127.0.0.1:{srv.port}", eng
    srv.stop()
    eng.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "tpu_dra.cmds.explain", *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_reference_cli_reads_the_ports_endpoint(server):
    url, eng = server
    got = _cli("serve-stats", "--endpoint", url, "--engine", "obs-cli")
    want = tstats.render_text(tstats.RECORDER.query(engine="obs-cli"))
    assert got == want and "3 finished" in got
    got = _cli("kv", "--endpoint", url, "--engine", "obs-cli")
    want = tkv.render_text(json.loads(_get(f"{url}/debug/kv?engine=obs-cli")[1]))
    assert got.startswith("engine obs-cli: ")

    def untimed(text):  # the blocks' ages grew between the two reads
        return [re.sub(r" [0-9.]+ ((req|entry):)", r" - \1", line)
                for line in text.splitlines() if not line.startswith("  age:")]

    assert untimed(got) == untimed(want)
    got = _cli("requests", "--endpoint", url, "--engine", "obs-cli")
    assert "3 finished request(s)" in got


BAD = {"engine": ["format=xml", "limit=0", "limit=x"], "kv": ["format=xml", "limit=-1"],
       "requests": ["class=x", "format=yaml"], "traces": ["format=html", "limit=x"],
       "capacity": ["class=bogus", "stranded_after=x", "stranded_after=-1", "format=xml"]}


def test_every_route_answers_and_bad_queries_are_400s(server):
    url, eng = server
    status, body = _get(f"{url}/metrics")
    assert status == 200
    assert 'tpu_dra_serve_queue_depth{engine="obs-cli"} 0.0' in body
    assert 'tpu_dra_serve_tier_engines{engine="obs-cli",tier="mono"} 1.0' in body
    for route in ("engine", "kv", "requests", "capacity", "traces"):
        for fmt in ("json", "text"):
            status, body = _get(f"{url}/debug/{route}?format={fmt}&engine=obs-cli")
            assert status == 200 and body, (route, fmt)
    doc = json.loads(_get(f"{url}/debug/capacity")[1])
    assert [e["steps"] for e in doc["engines"] if e["engine"] == "obs-cli"] == [
        eng.capacity_snapshot()["steps"]]
    raw = json.loads(_get(f"{url}/debug/traces?format=raw&trace_id="
                          f"{eng.request(0).trace_id}")[1])
    assert sorted(s["name"] for s in raw["spans"]) == [
        "serve.admit", "serve.decode", "serve.queue", "serve.request"]
    ref = jmetrics.MetricsServer("127.0.0.1:0")
    ref.start()
    try:
        for route, queries in BAD.items():
            for q in queries:
                codes = []
                for base in (url, f"http://127.0.0.1:{ref.port}"):
                    with pytest.raises(urllib.error.HTTPError) as err:
                        _get(f"{base}/debug/{route}?{q}")
                    codes.append((err.value.code, err.value.read().decode()))
                assert codes[0] == codes[1] and codes[0][0] == 400, (route, q)
    finally:
        ref.stop()
