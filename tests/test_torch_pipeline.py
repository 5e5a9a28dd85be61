"""The port's pipeline parallelism (tpu_dra_torch/parallel/pipeline.py,
spmd.line_hop, the pipelined branches of burnin.py, models' pipelined
family) against the reference's (tpu_dra/parallel/pipeline.py,
burnin.py, models) on its 8 virtual CPU devices.

The port's side runs in 8 gloo ranks spawned once for this module
(`test_torch_sharded.Ranks`, threads capped at 1), each returning what it
computed on its shards; the parent puts them back together while it
compiles the reference's pipelined programs (``xla_allow_excess_precision``
off).  Every case starts from the reference's own initial state, cut
into each rank's shards by `weights.shard_state`, on the same numpy
tokens.

Tolerances:

- meshes, specs, scaled configs and refusals: equal, word for word (a
  module path naming the port's);
- pipelined logits (dense, data 2, pipe 4, model 1) within 2 bf16 ulps
  of the largest logit of the reference's ``forward_pipelined`` and of
  the port's own unpipelined forward (with ``model`` 1 no partial sum is
  rounded per rank);
- training (the reference's "pipeline x2 + tp x2 + moe" stanza on data
  2, pipe 2, model 2, and the same without experts): the first loss
  within ``rtol=1e-3`` of the reference's pipelined step, three losses
  within ``rtol=1e-2``; every gradient leaf after step 1 (the momentum,
  which holds it) within 2 bf16 ulps of the leaf's largest magnitude, or
  within twice the reference's own pipelined-vs-unpipelined gap on it
  (the unpipelined step averages the load-balance term over the whole
  batch, not over microbatches, and rounds its tp partial sums
  elsewhere).  ``embed``, ``pos`` and ``ln_f``, whole on every pipe
  rank, are among the leaves: a gradient counted once a pipe rank would
  be P times the reference's;
- hops: M + P - 1 forward and as many reverse a step on every rank.

Every MoE case records the smallest top-2 router margin the port met and
asserts it above ``ROUTER_TIE``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_sharded as tsh
from test_torch_long_context import route_margins
from test_torch_moe import ROUTER_TIE
from tpu_dra import models as jmodels
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import pipeline as jpipe
from tpu_dra_torch import models as tmodels
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import pipeline as tpipe
from tpu_dra_torch.parallel import spmd, weights
from tpu_dra_torch.parallel.mesh import mesh_shape

torch.set_num_threads(1)

WORLD = 8
# The reference's "pipeline x2 + tp x2 + moe" stanza (__graft_entry__.py).
STANZA = dict(n_layers=2, seq=64, d_model=64, d_ff=128, pipeline_stages=2, moe_experts=2)
STANZA_MESH = dict(stages=2, model=2)
TRAIN_CASES = {"stanza": STANZA, "dense": dict(STANZA, moe_experts=0)}
# tests/test_pipeline.py's pipelined forward: 4 stages, data 2, model 1.
LOGITS = dict(pipeline_stages=4, n_layers=4, batch=8, seq=64, vocab=64, d_model=32, n_heads=4,
              d_ff=64)
LOGITS_MESH = dict(stages=4)
FAMILY = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=16)
REFUSED = {"ring": dict(ring_attention=True), "flash": dict(flash_attention=True)}
# (ranks, pipeline_mesh's keywords): shapes, then the two refusals.
MESHES = [(8, dict(stages=4)), (8, dict(stages=2, model=2)), (8, dict(stages=2, data=2, model=2)),
          (4, dict(stages=2, model=2)), (1, dict(stages=1)), (2, dict(stages=2))]
BAD_MESHES = [(8, dict(stages=3)), (8, dict(stages=2, model=3)), (8, dict(stages=2, data=3)),
              (1, dict(stages=2))]


def _sizes(mesh_kw, n=WORLD):
    return tpipe.pipeline_sizes(n, **mesh_kw)


def _rows(tokens, cfg, sizes, rank):
    place = tsh._coords(sizes, rank)
    return torch.tensor(tokens[spmd.local_slices(tb.token_spec(cfg), tokens.shape, sizes, place)])


# --- what each rank runs ------------------------------------------------


def _rank_logits(rank, args):
    """The pipelined forward on the rank's shards, and the meshes'
    shapes as the port's `DeviceMesh` holds them."""
    fields, state_np, tokens = args
    mesh = tpipe.pipeline_mesh(**LOGITS_MESH)
    cfg = tb.BurninConfig(**fields)
    params = weights.shard_state(state_np, cfg, mesh, dist.get_rank(), device="cpu")[0]
    with torch.no_grad():
        logits, aux = tb.forward(params, _rows(tokens, cfg, mesh_shape(mesh), rank), cfg, mesh,
                                 return_aux=True)
    shapes = {str(kw): mesh_shape(tpipe.pipeline_mesh(range(n), **kw))
              for n, kw in MESHES if n == WORLD}
    return logits.numpy(), float(aux), shapes


def _rank_train(rank, cases):
    """Each case's 3 steps on the rank's shards: the losses, the state
    after step 1, the hops a step in each direction, and the smallest
    router margin met."""
    out = {}
    real_hop = spmd.line_hop
    for name, fields, state_np, tokens in cases:
        mesh = tpipe.pipeline_mesh(**STANZA_MESH)
        cfg = tb.BurninConfig(**fields)
        state = weights.shard_state(state_np, cfg, mesh, dist.get_rank(), device="cpu")
        rows = _rows(tokens, cfg, mesh_shape(mesh), rank)
        step, _ = tb.make_train_step(cfg, mesh, with_state=False)
        hops = []

        def counting(x, place, axis, *, reverse=False):
            hops[-1][reverse] += 1
            return real_hop(x, place, axis, reverse=reverse)

        losses, after_one = [], None
        spmd.line_hop = counting
        try:
            with route_margins() as margins:
                for i in range(3):
                    hops.append({False: 0, True: 0})
                    state, loss = step(state, rows)
                    losses.append(float(loss))
                    if i == 0:
                        after_one = (tsh._numpy_tree(state[0]), tsh._numpy_tree(state[1]))
        finally:
            spmd.line_hop = real_hop
        out[name] = (losses, after_one, hops, min(margins) if margins else None)
    return out


def _rank_family(rank, fields):
    r = tmodels.train_family("pipelined", list(range(WORLD)), steps=2, device="cpu", **fields)
    return dataclasses.asdict(r)


# --- the reference's side -----------------------------------------------


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, "conftest must provide 8 virtual CPU devices"
    return devs


def _init(cfg, seed):
    state = jax.tree_util.tree_map(np.asarray, jb._init_state(cfg))
    tokens = np.random.RandomState(seed).randint(0, cfg.vocab, (cfg.batch, cfg.seq)).astype(
        np.int32)
    return state, tokens


@pytest.fixture(scope="module")
def logits_inputs(devices):
    cfg = jb.BurninConfig(**LOGITS).scaled_to(jpipe.pipeline_mesh(devices, **LOGITS_MESH))
    return (cfg, *_init(cfg, 4))


@pytest.fixture(scope="module")
def train_inputs(devices):
    jmesh = jpipe.pipeline_mesh(devices, **STANZA_MESH)
    cases = {}
    for name, fields in TRAIN_CASES.items():
        cfg = jb.BurninConfig(**fields).scaled_to(jmesh)
        cases[name] = (cfg, *_init(cfg, 3))
    return cases


@pytest.fixture(scope="module")
def ranks(logits_inputs, train_inputs):
    lcfg, lstate, ltokens = logits_inputs
    cases = [(name, dataclasses.asdict(cfg), state, tokens)
             for name, (cfg, state, tokens) in train_inputs.items()]
    r = tsh.Ranks([("logits", _rank_logits, (dataclasses.asdict(lcfg), lstate, ltokens)),
                   ("train", _rank_train, cases), ("family", _rank_family, FAMILY)])
    yield r
    r.stop()


def tree_diff(a, b):
    return jax.tree_util.tree_map(lambda x, y: np.asarray(x) - np.asarray(y), a, b)


class TestLayout:
    @pytest.mark.parametrize("n,kw", MESHES, ids=lambda v: str(v))
    def test_pipeline_mesh_shape_is_the_references(self, devices, n, kw):
        assert _sizes(kw, n) == dict(jpipe.pipeline_mesh(devices[:n], **kw).shape)

    @pytest.mark.parametrize("n,kw", BAD_MESHES, ids=lambda v: str(v))
    def test_pipeline_mesh_errors_are_the_references(self, devices, n, kw):
        with pytest.raises(ValueError) as want:
            jpipe.pipeline_mesh(devices[:n], **kw)
        with pytest.raises(ValueError) as got:
            tpipe.pipeline_mesh(range(n), **kw)
        assert str(got.value) == str(want.value)

    def test_the_ranks_meshes(self, ranks):
        for res in ranks.get():
            for n, kw in MESHES:
                if n == WORLD:
                    assert res["logits"][2][str(kw)] == _sizes(kw)

    @pytest.mark.parametrize("fields", [dict(n_layers=3, batch=3), dict(n_layers=5, batch=20),
                                        dict(moe_experts=3, n_heads=3, d_model=48),
                                        dict(n_layers=2, batch=8, pipeline_microbatches=2)],
                             ids=["l3b3", "l5b20", "moe3", "m2"])
    @pytest.mark.parametrize("mesh_kw", [dict(stages=4), dict(stages=2, model=2),
                                         dict(stages=2, data=4)], ids=["p4", "p2m2", "p2d4"])
    def test_scaled_config_and_specs_equal_the_references(self, devices, fields, mesh_kw):
        jmesh = jpipe.pipeline_mesh(devices, **mesh_kw)
        jcfg = jb.BurninConfig(pipeline_stages=1, **fields).scaled_to(jmesh)
        tcfg = tb.BurninConfig(pipeline_stages=1, **fields).scaled_to(_sizes(mesh_kw))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.pipeline_stages == mesh_kw["stages"]
        assert tcfg.n_layers % tcfg.pipeline_stages == 0
        assert tcfg.batch % (jmesh.shape["data"] * tcfg.pipeline_microbatches) == 0
        # A spec names one entry a dim in the port; the reference's may stop
        # short (``P("pipe")`` for the (L, d) norms), the rest replicated.
        shapes = jax.tree_util.tree_map(lambda a: a.ndim, jb.init_params(jcfg))
        specs = jax.tree_util.tree_map(
            lambda s, n: tuple(s) + (None,) * (n - len(s)), jb.param_specs(jcfg, jmesh), shapes,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert tb.param_specs(tcfg, _sizes(mesh_kw)) == specs
        assert tb.token_spec(tcfg) == tuple(jb.token_spec(jcfg)) == ("data", None)

    def test_scaled_to_a_mesh_without_pipe_is_refused(self, devices):
        jmesh = tsh.jlogical(devices, data=2, fsdp=2, model=2)
        with pytest.raises(ValueError) as want:
            jb.BurninConfig(pipeline_stages=2).scaled_to(jmesh)
        with pytest.raises(ValueError) as got:
            tb.BurninConfig(pipeline_stages=2).scaled_to(tsh.MESH_3)
        assert str(got.value) == str(want.value).replace("tpu_dra.", "tpu_dra_torch.")

    @pytest.mark.parametrize("name", sorted(REFUSED))
    def test_ring_and_flash_with_a_pipeline_are_refused(self, devices, name):
        jmesh = jpipe.pipeline_mesh(devices, stages=4)
        jcfg = jb.BurninConfig(n_layers=4, pipeline_stages=4, **REFUSED[name]).scaled_to(jmesh)
        with pytest.raises(ValueError) as want:
            jb.forward(jb.init_params(jcfg), jnp.zeros((jcfg.batch, jcfg.seq), jnp.int32), jcfg,
                       jmesh)
        with pytest.raises(ValueError) as got:
            tb._check_parallelism(tb.BurninConfig(**dataclasses.asdict(jcfg)),
                                  _sizes(dict(stages=4)))
        assert str(got.value) == str(want.value)

    def test_a_pipeline_without_a_pipe_mesh_is_refused(self):
        jcfg = jb.BurninConfig(pipeline_stages=4, **(tsh.TINY | dict(n_layers=4)))
        with pytest.raises(ValueError) as want:
            jb.forward(jb.init_params(jcfg), jnp.zeros((1, jcfg.seq), jnp.int32), jcfg)
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))
        params = tb.init_params(tcfg, device="cpu")
        for mesh in (None, tsh.MESH_3):
            with pytest.raises(ValueError) as got:
                if mesh is None:
                    tb.forward(params, torch.zeros((1, tcfg.seq), dtype=torch.int32), tcfg)
                else:
                    tb._check_parallelism(tcfg, mesh)
            assert str(got.value) == str(want.value).replace("tpu_dra.", "tpu_dra_torch.")

    def test_forward_divisibility_refusals_are_the_references(self, devices):
        jmesh = jpipe.pipeline_mesh(devices, stages=4)
        place = _Place(_sizes(dict(stages=4)))
        for fields in (dict(n_layers=3, batch=8), dict(n_layers=4, batch=6)):
            jcfg = jb.BurninConfig(pipeline_stages=4, **fields)
            with pytest.raises(ValueError) as want:
                jpipe.forward_pipelined(jb.init_params(jcfg),
                                        jnp.zeros((jcfg.batch, jcfg.seq), jnp.int32), jcfg, jmesh)
            with pytest.raises(ValueError) as got:
                tpipe.check_config(tb.BurninConfig(pipeline_stages=4, **fields), place)
            assert str(got.value) == str(want.value)


class _Place:
    """Sizes only: what `pipeline.check_config` reads of a place."""

    def __init__(self, sizes):
        self.sizes = sizes

    def size(self, axis):
        return self.sizes.get(axis, 1)


class TestLogits:
    def test_equal_the_references_and_the_unpipelined_forward(self, ranks, devices,
                                                              logits_inputs):
        jcfg, state, tokens = logits_inputs
        jmesh = jpipe.pipeline_mesh(devices, **LOGITS_MESH)
        p, t = jax.tree_util.tree_map(jnp.asarray, state[0]), jnp.asarray(tokens)
        want = np.asarray(jax.jit(lambda p, t: jpipe.forward_pipelined(p, t, jcfg, jmesh)[0])
                          .lower(p, t).compile({"xla_allow_excess_precision": False})(p, t))
        sizes = _sizes(LOGITS_MESH)
        got = np.zeros_like(want)
        for rank, res in enumerate(ranks.get()):
            sl = spmd.local_slices((("data",), "model", None), want.shape, sizes,
                                   tsh._coords(sizes, rank))
            if rank % 4 == 0:
                got[sl] = res["logits"][0]
            else:  # every pipe rank holds the whole output
                np.testing.assert_array_equal(res["logits"][0], got[sl])
            assert res["logits"][1] == 0.0  # dense: no load-balance term
        tol = tsh.ulps2(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))
        params = weights.state_from_numpy(state, tcfg, device="cpu")[0]
        with torch.no_grad():
            one = tb.forward(params, torch.tensor(tokens),
                             dataclasses.replace(tcfg, pipeline_stages=0)).numpy()
        np.testing.assert_allclose(got, one, rtol=0, atol=tol)


class TestTraining:
    @pytest.mark.parametrize("name", sorted(TRAIN_CASES))
    def test_steps_and_gradients_equal_the_references(self, ranks, devices, train_inputs, name):
        jcfg, state, tokens = train_inputs[name]
        jmesh = jpipe.pipeline_mesh(devices, **STANZA_MESH)
        want_losses, want_grads = tsh.reference_run(jcfg, jmesh, state, tokens, 3)
        _, one_grads = tsh.reference_run(dataclasses.replace(jcfg, pipeline_stages=0), None,
                                         state, tokens, 1)
        results = [res["train"][name] for res in ranks.get()]
        losses = results[0][0]
        assert all(r[0] == losses for r in results)  # one global loss on every rank
        np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-3)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg))
        sizes = _sizes(STANZA_MESH)
        got = weights.gather_state([(r[1][1], r[1][1]) for r in results], tcfg, sizes)[0]
        tsh.assert_grads_close(got, want_grads, tree_diff(want_grads, one_grads),
                               f"pipelined {name}")
        margin = results[0][3]
        if jcfg.moe_experts:
            print(f"{name}: smallest router top-2 margin {min(r[3] for r in results):.3e}")
            assert min(r[3] for r in results) > ROUTER_TIE
        else:
            assert margin is None

    def test_hops_a_step(self, ranks):
        """M + P - 1 hops forward and as many back on every rank each step
        (the reference's one ``ppermute`` a tick, and its transpose)."""
        cfg = tb.BurninConfig(**STANZA)
        ticks = cfg.pipeline_microbatches + STANZA_MESH["stages"] - 1
        for res in ranks.get():
            for name in TRAIN_CASES:
                assert res["train"][name][2] == [{False: ticks, True: ticks}] * 3


class TestFamily:
    def test_pipelined_trains_over_eight_ranks(self, ranks, devices):
        want = jmodels.train_family("pipelined", devices, steps=2, **FAMILY)
        for res in ranks.get():
            got = res["family"]
            assert got["ok"] and want.ok, (got, want)
            assert got["steps"] == want.steps == 2 and got["loss_last"] < got["loss_first"]
        assert len({res["family"]["loss_first"] for res in ranks.get()}) == 1

    def test_one_device_is_refused_with_the_references_words(self, devices):
        want = jmodels.train_family("pipelined", devices[:1], steps=2, **FAMILY)
        got = tmodels.train_family("pipelined", steps=2, device="cpu", **FAMILY)
        assert not got.ok and not want.ok and got.steps == 0
        assert got.error == want.error == (
            "ValueError: 1 devices not divisible into 2 stages x 1 model")


class _TwoStages:
    """A place at stage ``i`` of a 2-rank ``pipe`` axis whose collectives
    the tests fake."""

    def __init__(self, i):
        self.sizes, self.coords = {"pipe": 2}, {"pipe": i}

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        return None


class TestHopsHandNcclContiguousTensors:
    """NCCL refuses a non-contiguous tensor; gloo takes one, so the ranks
    cannot show it.  The hop and the pipe all-reduce run here against
    fakes that check what they are handed."""

    @pytest.fixture
    def handed(self, monkeypatch):
        handed = []

        class Op:
            def __init__(self, fn, t, peer, group):
                handed.append((fn, t, peer))

        monkeypatch.setattr(dist, "P2POp", Op)
        monkeypatch.setattr(dist, "batch_isend_irecv", lambda ops: [])
        monkeypatch.setattr(dist, "get_global_rank", lambda group, r: r)
        return handed

    @pytest.mark.parametrize("i,reverse,want", [(0, False, [("isend", 1)]),
                                                (1, False, [("irecv", 0)]),
                                                (0, True, [("irecv", 1)]),
                                                (1, True, [("isend", 0)])])
    def test_line_hop_of_a_transposed_view(self, handed, i, reverse, want):
        x = torch.randn(4, 6).t()
        out = spmd.line_hop(x, _TwoStages(i), "pipe", reverse=reverse)
        assert [(fn.__name__, peer) for fn, _, peer in handed] == want
        assert all(t.is_contiguous() for _, t, _ in handed)
        assert (out is None) == (want[0][0] == "isend")
        if out is not None:
            assert out.shape == x.shape and out.is_contiguous()

    def test_whole_over_pipe_sums_one_contiguous_buffer(self, monkeypatch):
        def all_reduce(t, group=None):
            assert t.is_contiguous() and t.dtype == torch.float32
            t.mul_(2)

        monkeypatch.setattr(dist, "all_reduce", all_reduce)
        out = torch.randn(3, 4, 5).permute(2, 0, 1)
        whole, aux = tpipe._whole_over_pipe(out, torch.tensor(1.5), _TwoStages(1))
        torch.testing.assert_close(whole, 2 * out)
        assert float(aux) == 3.0


class TestValidate:
    def test_pipelined_family_refused_on_one_device(self, capsys):
        import json

        from tpu_dra_torch.parallel import validate as tval

        assert tval.main(["--family", "pipelined", "--train", "2"], device="cpu") == 1
        out = json.loads(capsys.readouterr().out)
        assert out["family"] == "pipelined" and out["ok"] is False
        assert out["error"] == "ValueError: 1 devices not divisible into 2 stages x 1 model"

    def test_pipelined_family_trains_over_four_devices(self, capsys):
        """One worker a device, the family over (data 1, pipe 2, model 2)."""
        import json

        from tpu_dra_torch.parallel import validate as tval

        assert tval.main(["--family", "pipelined", "--train", "2"], device="cpu",
                         local_devices=4) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["family"] == "pipelined" and out["ok"] is True and out["steps"] == 2
