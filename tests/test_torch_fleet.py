"""The reference's fleet router (tpu_dra/fleet/fleet.py `ServeFleet`)
over two of the port's engines (tpu_dra_torch/parallel/serve.py: ``name``,
`validate_request`, `submit(seed=, stop_sequences=, trace_parent=)`,
`prefix_digest`, `prefix_epoch`, `peek_prefix`, `slo_counts`) against the
same fleet over two of the reference's engines, on tests/test_fleet.py's
config, weights and two-family stream, ticked without threads.

- Placements are equal request by request (replica, reason, matched
  length), the routing counts are equal, and tokens are equal up to a
  reference near-tie (test_torch_prefix.assert_same_tokens).
- With every replica at its cap, both fleets park the same requests
  fleet-side, tick by tick, and place them in the same order.
- `scale_hint` reads the same verdicts from `slo_counts`, with targets
  that every request meets and that every request misses."""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from test_fleet import CFG as JCFG
from test_fleet import PARAMS as JPARAMS
from test_fleet import SYS_A, SYS_B, tail
from test_torch_prefix import assert_same_tokens, settled
from tpu_dra.fleet import stats as fleetstats
from tpu_dra.fleet.fleet import ServeFleet
from tpu_dra.parallel.serve import ServeEngine as JaxEngine
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel.serve import ServeEngine
from tpu_dra_torch.parallel.weights import params_from_numpy
from tpu_dra_torch.utils import trace as ttrace

torch.set_num_threads(2)

TCFG = tb.BurninConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})
TPARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, JPARAMS), device="cpu")
_RUN_IDS = itertools.count()


def _spec(kw):
    kw = dict(kw)
    kw.setdefault("prefix_cache_slots", 4)
    kw.setdefault("prefix_window", 8)
    kw.setdefault("slots", 2)
    return dict(prompt_slots=32, max_new_cap=4, **kw)


def port_engine(name, **kw):
    """A port engine behind the reference's router.  The router mints the
    reference's trace contexts and the engine takes only the port's
    (`submit` checks the type, as the reference's does), so the route's
    context is handed down as the port's, same ids."""
    eng = ServeEngine(TPARAMS, TCFG, name=name, device="cpu", **_spec(kw))
    submit = eng.submit

    def routed(*args, trace_parent=None, **kwargs):
        if trace_parent is not None:
            trace_parent = ttrace.TraceContext(trace_parent.trace_id, trace_parent.span_id,
                                               trace_parent.flags)
        return submit(*args, trace_parent=trace_parent, **kwargs)

    eng.submit = routed
    return eng


def ref_engine(name, **kw):
    return settled(JaxEngine(JPARAMS, JCFG, name=name, attn_backend="gather", **_spec(kw)))


def _fleet(make, side, engine_kw=None, **fleet_kw):
    tag = f"{side}-{next(_RUN_IDS)}"
    engines = [make(f"{tag}-{i}", **(engine_kw or {})) for i in range(2)]
    return ServeFleet(engines, parallel_ticks=False, name=f"fleet-{tag}", **fleet_kw), tag


def _placements(fleet, tag):
    """(fleet id, replica index, reason, matched) of every placement."""
    return [(r.request, r.replica[len(tag) + 1:], r.reason, r.matched)
            for r in fleetstats.RECORDER.query(fleet=fleet.name)]


def _families(make, side, engine_kw=None):
    """test_fleet's two-family stream, one arrival a tick, then drained."""
    fleet, tag = _fleet(make, side, engine_kw)
    fids = []
    for i in range(8):
        fids.append(fleet.submit((SYS_A if i % 2 == 0 else SYS_B) + tail(i), 4))
        fleet.tick()
    fid = fleet.submit(SYS_A + tail(99), 2, use_prefix_cache=False)
    fids.append(fid)
    fleet.run()
    reqs = [fleet.result(f) for f in fids]
    out = dict(
        placements=_placements(fleet, tag),
        routed=fleet.fleet_stats()["routed"],
        prompts=[r.prompt for r in reqs],
        tokens=[list(r.tokens) for r in reqs],
        reasons=[r.finish_reason for r in reqs],
        reused=[r.prefix_reused for r in reqs],
        slo=[tuple(fleet.engine(n).slo_counts) for n in fleet.replicas],
        hint=fleet.scale_hint(),
        replicas={r.replica[len(tag) + 1:] for r in reqs},
    )
    fleet.close()
    return out


class TestFleetOverPortReplicas:
    @pytest.mark.parametrize("slo", [None, 1e-9, 1e9], ids=["no_slo", "all_missed", "all_met"])
    def test_placements_tokens_and_scale_hint_equal_the_reference_fleet(self, slo):
        kw = {} if slo is None else {"ttft_slo_s": slo, "tpot_slo_s": slo}
        got, want = _families(port_engine, "port", kw), _families(ref_engine, "ref", kw)
        assert got["placements"] == want["placements"]
        assert got["routed"] == want["routed"] and got["routed"]["affinity"] >= 6
        assert got["replicas"] == {"0", "1"}
        assert (got["reasons"], got["reused"], got["slo"]) == (
            want["reasons"], want["reused"], want["slo"])
        assert_same_tokens(JCFG, JPARAMS, got["prompts"], got["tokens"], want["tokens"])
        assert got["hint"] == want["hint"]
        if slo is not None:
            n = len(got["tokens"])
            assert sum(m for m, _ in got["slo"]) == (n if slo > 1 else 0)
            assert got["hint"]["goodput"] == (1.0 if slo > 1 else 0.0)
            assert got["hint"]["hint"] == ("grow" if slo < 1 else "shrink")

    def test_all_replicas_at_cap_queue_fleet_side_alike(self):
        runs = {}
        for side, make in (("port", port_engine), ("ref", ref_engine)):
            fleet, tag = _fleet(make, side, {"slots": 1}, max_queue_per_replica=1)
            fids = [fleet.submit(SYS_A + tail(i), 2) for i in range(7)]
            depths = [fleet.fleet_stats()["fleet_queue_depth"]]
            while fleet.fleet_stats()["fleet_queue_depth"] or any(
                    fleet.engine(n).pending for n in fleet.replicas):
                fleet.tick()
                depths.append(fleet.fleet_stats()["fleet_queue_depth"])
            reqs = [fleet.result(f) for f in fids]
            runs[side] = dict(depths=depths, placements=_placements(fleet, tag),
                              samples=list(fleet._queue_samples), reqs=reqs)
            fleet.close()
        got, want = runs["port"], runs["ref"]
        assert got["depths"][0] == 5
        assert got["depths"] == want["depths"]
        assert got["samples"] == want["samples"]
        assert got["placements"] == want["placements"]
        order = [f for f, _, _, _ in got["placements"]]
        assert order == sorted(order)
        first, last = got["reqs"][0], got["reqs"][-1]
        assert last.queue_wait_s > first.queue_wait_s and last.queue_wait_s <= last.ttft_s
        assert_same_tokens(JCFG, JPARAMS, [r.prompt for r in got["reqs"]],
                           [r.tokens for r in got["reqs"]],
                           [list(r.tokens) for r in want["reqs"]])
