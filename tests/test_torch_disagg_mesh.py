"""The port's disaggregated server with both tiers on a mesh
(tpu_dra_torch/parallel/disagg.py with ``mesh=`` in the tier specs)
against the reference's (tpu_dra/parallel/disagg.py with mesh tiers) on
its 8 virtual CPU devices, at tests/test_disagg.py's stream.

The port's side runs in 8 gloo ranks spawned once for this module
(`test_torch_sharded.Ranks`) on the mesh data 2, fsdp 2, model 2; each
rank builds its server over its shards of the reference's weights
(`weights.shard_params`) and serves the stream in both handoff modes.
After every tick each rank checks the cross-tier block conservation
(`helpers.assert_kv_conserved`) and, under alias, that its two tiers
still share one pool dict and one allocator.  Held:

- every rank's tokens equal; equal to the reference's one-device oracle
  (test_serve.isolated) up to a near-tie of its logits
  (test_torch_prefix.assert_same_tokens), the reference's mesh tokens
  being no oracle (ROADMAP Queue 3, the PR 12 reference fault);
- `disagg_stats()` (apart from the server's name) and both tiers'
  `kv_block_stats` after every tick, and every `StepRecord` integer
  field of both tiers tick for tick: equal on every rank and equal to
  the reference's mesh server's;
- tiers on two different meshes are refused.

No collective is added: a handoff is host bookkeeping (alias) or each
rank's own block copies (dma), so there is nothing new to hand NCCL."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import test_torch_sharded as tsh
from helpers import assert_kv_conserved
from test_disagg import STREAM
from test_serve import isolated
from test_torch_prefix import assert_same_tokens
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel.disagg import DisaggServer as JaxServer
from tpu_dra.parallel.mesh import logical_mesh as jlogical
from tpu_dra.utils import servestats as jstats
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import weights
from tpu_dra_torch.parallel.disagg import DisaggServer
from tpu_dra_torch.parallel.mesh import logical_mesh as tlogical
from tpu_dra_torch.utils import servestats as tstats

torch.set_num_threads(1)

MESH = dict(data=2, fsdp=2, model=2)
# tests/test_serve.py's config.
SERVE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32, batch=4)
PREFILL = dict(slots=2, prompt_slots=8, max_new_cap=5, prefix_window=2)
DECODE = dict(PREFILL, slots=4)
MODES = ("alias", "dma")
INT_FIELDS = ("occupancy", "slots", "queue_depth", "admitted", "prefix_hits", "finished",
              "tokens", "preempted", "swapped_in", "slo_met", "slo_missed")


def _steps(stats, name):
    return {tier: [{f: getattr(r, f) for f in INT_FIELDS}
                   for r in stats.RECORDER.query(engine=f"{name}-{tier}")]
            for tier in ("prefill", "decode")}


def _stats(srv):
    out = srv.disagg_stats()
    out.pop("server")
    return out


def _drive(srv, on_tick=None):
    """The stream through ``srv``: returns each request's tokens, and
    after every tick the server's stats and both tiers' block counts."""
    dids = [srv.submit(p, m, priority=pr) for p, m, pr in STREAM]
    ticks = []
    while srv.pending:
        srv.tick()
        if on_tick is not None:
            on_tick(srv)
        ticks.append((_stats(srv), {t: e.kv_block_stats for t, e in srv.tiers.items()}))
    return [[int(t) for t in srv.result(d).tokens] for d in dids], ticks


def _conserved(srv):
    assert_kv_conserved(srv)
    if srv.handoff == "alias":
        pre, dec = srv.tiers["prefill"], srv.tiers["decode"]
        assert pre._pool is dec._pool and pre._balloc is dec._balloc


def _rank_disagg(rank, args):
    fields, tree = args
    mesh = tlogical(**MESH)
    cfg = tb.BurninConfig(**fields)
    params = weights.shard_params(weights.params_from_numpy(tree, device="cpu"), cfg, mesh)
    out = {}
    for mode in MODES:
        name = f"mesh-disagg-{mode}"
        srv = DisaggServer(params, cfg, prefill=dict(PREFILL, mesh=mesh),
                           decode=dict(DECODE, mesh=mesh), handoff=mode, name=name)
        tokens, ticks = _drive(srv, _conserved)
        srv.close()
        out[mode] = (tokens, ticks, _steps(tstats, name))
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's weights, its mesh servers' runs, and its
    one-device oracle."""
    jcfg = jb.BurninConfig(**SERVE)
    jparams = jb.init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, jparams


@pytest.fixture(scope="module")
def ranks(reference):
    jcfg, jparams = reference
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    r = tsh.Ranks([("disagg", _rank_disagg, (dataclasses.asdict(jcfg), tree))])
    yield r
    r.stop()


@pytest.fixture(scope="module")
def reference_runs(reference, ranks):
    jcfg, jparams = reference
    jmesh = jlogical(jax.devices(), **MESH)
    out = {}
    for mode in MODES:
        name = f"ref-mesh-disagg-{mode}"
        srv = JaxServer(jparams, jcfg, prefill=dict(PREFILL, mesh=jmesh),
                        decode=dict(DECODE, mesh=jmesh), handoff=mode, name=name)
        tokens, ticks = _drive(srv)
        srv.close()
        out[mode] = (tokens, ticks, _steps(jstats, name))
    oracle = [[int(t) for t in isolated(jparams, jcfg, p, m)] for p, m, _ in STREAM]
    return out, oracle


@pytest.mark.parametrize("mode", MODES)
def test_tokens_equal_on_every_rank_and_match_the_oracle(ranks, reference, reference_runs,
                                                         mode):
    jcfg, jparams = reference
    results = ranks.get()
    tokens = [res["disagg"][mode][0] for res in results]
    assert all(t == tokens[0] for t in tokens)
    _, oracle = reference_runs
    assert_same_tokens(jcfg, jparams, [p for p, _, _ in STREAM], tokens[0], oracle)
    assert [len(t) for t in tokens[0]] == [m for _, m, _ in STREAM]


@pytest.mark.parametrize("mode", MODES)
def test_stats_blocks_and_step_records_match_the_references_mesh_server(ranks, reference_runs,
                                                                        mode):
    results = ranks.get()
    want_ticks, want_steps = reference_runs[0][mode][1:]
    for res in results:
        _, ticks, steps = res["disagg"][mode]
        assert ticks == want_ticks
        assert steps == want_steps
    assert want_steps["decode"] and sum(s["finished"] for s in want_steps["decode"]) > 0
    handed = want_ticks[-1][0]["decode"]
    assert handed[f"handoffs_{mode}"] == handed["handoff_in_requests"] > 0


def test_tiers_on_different_meshes_are_refused(reference):
    jcfg, _ = reference
    tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))

    def fake(ranks_, names=("data", "fsdp", "model")):
        return types.SimpleNamespace(mesh=torch.tensor(ranks_).reshape(1, 1, -1),
                                     mesh_dim_names=names)

    for pre, dec in ((fake([0, 1]), None), (None, fake([0, 1])), (fake([0, 1]), fake([2, 3])),
                     (fake([0, 1]), fake([0, 1], ("data", "model", "fsdp")))):
        for mode in MODES:
            with pytest.raises(ValueError, match="the tiers must run on one mesh"):
                DisaggServer({}, tcfg, prefill=dict(PREFILL, mesh=pre),
                             decode=dict(DECODE, mesh=dec), handoff=mode)
