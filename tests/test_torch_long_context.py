"""The port's long-context training on a mesh (tpu_dra_torch/parallel/
ulysses.py, spmd.all_to_all, moe.py's group-local routing and the cp
branches of burnin.py) against the reference's (tpu_dra/parallel/
ulysses.py, moe.py, burnin.py) on its 8 virtual CPU devices.

The port's side runs in 8 gloo ranks spawned once for this module
(`test_torch_sharded.Ranks`, threads capped at 1, each wait bounded),
each returning what it computed on its shards; the parent puts them
back together while it compiles the reference's sharded programs
(``xla_allow_excess_precision`` off; its flash kernel in Pallas interpret
mode, the port's as its plain version).  Training starts from the
reference's initial state cut into each rank's shards, on the same numpy
tokens, as in tests/test_torch_sharded.py.

Tolerances:

- the all-to-all: equal (it only moves data);
- Ulysses attention in f32: outputs and the gradients of a fixed scalar
  within ``1e-5`` of the reference's ``reference_attention`` (the
  reference holds its own Ulysses to it exactly; the port sums in another
  order); in bf16 through the flash kernel, against the reference's
  Ulysses with its flash kernel: outputs within ``3e-2`` (the reference's
  own bf16 flash tolerance) and gradients within 2 bf16 ulps of each
  one's largest magnitude;
- ``moe_mlp_local``: one bf16 ulp of the reference's (``atol 2**-9``,
  ``rtol 2**-7``), equal to the global path at one group and wherever
  capacity never binds;
- training: as tests/test_torch_sharded.py states (first loss within
  ``rtol=1e-3``, three losses within ``1e-2``, gradient leaves within 2
  bf16 ulps or twice the reference's own sharded/single-device gap).  A
  cp x ep case's single-device step routes in the same groups as its
  mesh (the reference's and the port's global ``moe_mlp`` patched to
  ``moe_mlp_local``), so that its gap is the sharding's rounding alone.

Every MoE case records the smallest top-2 router margin the port met
(`route_margins`) and asserts it above ``ROUTER_TIE``."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import test_torch_sharded as tsh
from test_torch_burnin import both_params
from test_torch_moe import ROUTER_TIE, ULP_TOL
from tpu_dra import models as jmodels
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import decode as jd
from tpu_dra.parallel import moe as jmoe
from tpu_dra.parallel import ring as jring
from tpu_dra.parallel import ulysses as jul
from tpu_dra.parallel.mesh import logical_mesh as jlogical
from tpu_dra_torch import models as tmodels
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import decode as td
from tpu_dra_torch.parallel import moe as tmoe
from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel import ulysses as tul
from tpu_dra_torch.parallel.mesh import logical_mesh as tlogical

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Hold this process's torch work to one thread while the module's
    tests run.  The cap above is set at import, and a run of the whole
    suite imports every test module before the first test: the last
    module to set a count (2) wins, so the single-device steps ran on two
    threads there and on one alone (ROADMAP Queue 3, PR 14)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


WORLD = 8
# The reference's Ulysses test mesh and inputs (tests/test_ulysses.py).
ULY_MESH = dict(data=2, fsdp=1, model=4)
ATTN_SHAPE = (4, 64, 8, 16)  # (B, S, H, d): B over data, S over model
ATTN_SPEC = (("data", "fsdp"), "model", None, None)
FLASH_BLOCK = 16
ATTN_CASES = {"f32 causal": (torch.float32, True, False),
              "f32 full": (torch.float32, False, False),
              "bf16 flash": (torch.bfloat16, True, True)}
# The all-to-all's probe: each rank's (2, 8, 3, 4, 5) block, heads (dim 3)
# split and sequence (dim 1) concatenated over model, as Ulysses swaps.
A2A_SHAPE = (2, 8, 3, 4, 5)
A2A_SPEC = (("data", "fsdp", "model"), None, None, None, None, None)
TRAIN_CASES = {
    "ulysses": (dict(ulysses_attention=True), tsh.MESH_3),
    "ulysses_flash": (dict(ulysses_attention=True, flash_attention=True), tsh.MESH_3),
    "ulysses_moe": (dict(ulysses_attention=True, moe_experts=4), tsh.MOE_MESH),
    "ring_moe": (dict(ring_attention=True, moe_experts=4), tsh.MOE_MESH),
}


@contextlib.contextmanager
def route_margins():
    """Every routing of `moe.route` while open: yields the list of each
    call's smallest top-2 router probability margin."""
    margins = []
    real = tmoe.route

    def recording(layer, h):
        probs = real(layer, h)
        with torch.no_grad():
            top2 = torch.topk(probs, 2, dim=-1).values
            margins.append(float((top2[..., 0] - top2[..., 1]).min()))
        return probs

    tmoe.route = recording
    try:
        yield margins
    finally:
        tmoe.route = real


# --- what each rank runs ------------------------------------------------


def _rank_attention(rank, inputs):
    """`ulysses_attention_sharded` on ``ULY_MESH`` for each of
    ``ATTN_CASES``: the rank's output block and the gradients of
    sum(out * w); then the two divisibility errors."""
    out = {}
    q, k, v, w = inputs
    mesh = tlogical(**ULY_MESH)
    place = spmd.Place(mesh)
    sl = spmd.local_slices(ATTN_SPEC, ATTN_SHAPE, place.sizes, place.coords)
    for name, (dtype, causal, flash) in ATTN_CASES.items():
        qkv = [torch.tensor(a[sl]).to(dtype).requires_grad_() for a in (q, k, v)]
        o = tul.ulysses_attention_sharded(*qkv, mesh, "model", causal=causal, flash=flash,
                                          flash_block=FLASH_BLOCK)
        grads = torch.autograd.grad((o * torch.tensor(w[sl])).sum(), qkv)
        out[name] = [o.detach().float().numpy()] + [g.float().numpy() for g in grads]
    for name, shape, seq in (("heads", (2, 16, 6, 16), None), ("seq", (2, 8, 8, 16), 30)):
        t = torch.zeros(shape)
        try:
            tul.ulysses_attention_sharded(t, t, t, mesh, "model", seq=seq)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_a2a(rank, x_all):
    """`spmd.all_to_all` over ``model`` of ``ULY_MESH`` on the rank's
    block: its output, whether the inverse swap gives the block back
    bitwise, the adjoint identity's two sides and the autograd gradient
    against the inverse swap."""
    mesh = tlogical(**ULY_MESH)
    place = spmd.Place(mesh)
    x = torch.tensor(x_all[spmd.local_slices(A2A_SPEC, x_all.shape, place.sizes,
                                             place.coords)][0])
    y = spmd.all_to_all(x, place, "model", split_dim=3, concat_dim=1)
    back = spmd.all_to_all(y, place, "model", split_dim=1, concat_dim=3)
    g = torch.Generator().manual_seed(100 + rank)
    y2 = torch.randn(y.shape, generator=g, dtype=torch.float64)
    lhs = torch.tensor(float((y.double() * y2).sum()), dtype=torch.float64)
    rhs = torch.tensor(float((x.double() * spmd.all_to_all(y2, place, "model", split_dim=1,
                                                           concat_dim=3)).sum()),
                       dtype=torch.float64)
    dist.all_reduce(lhs)
    dist.all_reduce(rhs)
    xg = x.clone().requires_grad_()
    w = y2.float()
    (grad,) = torch.autograd.grad((spmd.all_to_all(xg, place, "model", 3, 1) * w).sum(), xg)
    inverse = spmd.all_to_all(w, place, "model", split_dim=1, concat_dim=3)
    return {"y": y.numpy(), "round_trip": torch.equal(back, x), "adjoint": (float(lhs), float(rhs)),
            "grad": torch.equal(grad, inverse), "contiguous": y.is_contiguous()}


def _rank_train(rank, cases):
    """`test_torch_sharded._rank_train` case by case, each MoE case's
    smallest router margin recorded beside it."""
    out = {}
    for case in cases:
        with route_margins() as margins:
            out.update(tsh._rank_train(rank, [case]))
        out[f"{case[0]} margin"] = min(margins) if margins else None
    return out


def _rank_bound(rank, _):
    """`routing_temp_comparison` on the CPU ranks, then its two forms
    through `moe._routing_peaks` with the output's shape in place of the
    card's peak allocation (the code the card runs, short of the
    allocator)."""
    mesh = tmoe.moe_mesh(data=2, model=2, expert=2)
    shapes = tmoe._routing_peaks(spmd.Place(mesh), lambda fn, device: tuple(fn().shape),
                                 seq=512, d_model=16, d_ff=32, experts=4)
    return tmoe.routing_temp_comparison(mesh), shapes


# --- the reference's side -----------------------------------------------


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, "conftest must provide 8 virtual CPU devices"
    return devs


@pytest.fixture(scope="module")
def attn_inputs():
    rng = np.random.RandomState(11)
    return tuple(rng.randn(*ATTN_SHAPE).astype(np.float32) for _ in range(4))


@pytest.fixture(scope="module")
def a2a_input():
    return np.random.RandomState(12).randn(WORLD, *A2A_SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def train_inputs(devices):
    cases = {}
    for name, (overrides, mesh_kw) in TRAIN_CASES.items():
        cfg = jb.BurninConfig(**tsh.TINY, **overrides).scaled_to(tsh.jax_mesh(devices, mesh_kw))
        state = jax.tree_util.tree_map(np.asarray, jb._init_state(cfg))
        tokens = np.random.RandomState(3).randint(0, cfg.vocab, (cfg.batch, cfg.seq)).astype(
            np.int32)
        cases[name] = (cfg, mesh_kw, state, tokens)
    return cases


@pytest.fixture(scope="module")
def ranks(train_inputs, attn_inputs, a2a_input):
    cases = [(name, dataclasses.asdict(cfg), mesh_kw, state, tokens)
             for name, (cfg, mesh_kw, state, tokens) in train_inputs.items()]
    r = tsh.Ranks([("attention", _rank_attention, attn_inputs), ("a2a", _rank_a2a, a2a_input),
                   ("train", _rank_train, cases), ("bound", _rank_bound, None)])
    yield r
    r.stop()


def test_the_module_runs_on_one_torch_thread():
    """The port's work in this process (the single-device steps the
    training cases hold the ranks to) runs on the one thread the module
    caps torch at, whichever test modules were imported after it."""
    assert torch.get_num_threads() == 1


class TestAllToAll:
    def test_is_jax_tiled_all_to_all_and_its_inverse(self, ranks, devices, a2a_input):
        """Each rank's output against ``jax.lax.all_to_all(tiled=True)``
        over the same axis; the inverse swap gives every block back
        bitwise, ⟨a2a(x), y⟩ = ⟨x, a2a⁻¹(y)⟩ over the ranks, and the
        gradient is the inverse swap of the cotangent."""
        jmesh = jlogical(devices, **ULY_MESH)
        spec = P(("data", "fsdp", "model"))

        def body(x):
            return jax.lax.all_to_all(x, "model", split_axis=4, concat_axis=2, tiled=True)

        want = np.asarray(jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=spec,
                                                out_specs=spec))(jnp.asarray(a2a_input)))
        results = ranks.get()
        for rank, res in enumerate(results):
            got = res["a2a"]
            np.testing.assert_array_equal(got["y"], want[rank])
            assert got["round_trip"] and got["grad"] and got["contiguous"], rank
            lhs, rhs = got["adjoint"]
            np.testing.assert_allclose(lhs, rhs, rtol=1e-12)

    def test_local_form_is_the_collectives(self, ranks, a2a_input):
        """`spmd.all_to_all_local` (the smoke run's layout of each rank's
        swapped tensors) gives every rank of one model group what the
        collective gave it."""
        results = ranks.get()
        group = [torch.tensor(a2a_input[r]) for r in range(4)]  # data 0: ranks 0-3 on model
        for rank, got in enumerate(spmd.all_to_all_local(group, 3, 1)):
            np.testing.assert_array_equal(got.numpy(), results[rank]["a2a"]["y"])


class TestUlyssesAttention:
    @pytest.mark.parametrize("case", sorted(ATTN_CASES))
    def test_output_and_gradients_equal_the_references(self, ranks, devices, attn_inputs, case):
        dtype, causal, flash = ATTN_CASES[case]
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        q, k, v = (jnp.asarray(a, jdt) for a in attn_inputs[:3])
        w = jnp.asarray(attn_inputs[3])
        jmesh = jlogical(devices, **ULY_MESH)

        def fn(q, k, v):
            if not flash:  # the reference holds its own Ulysses to the oracle exactly
                return jring.reference_attention(q, k, v, causal=causal)
            return jul.ulysses_attention_sharded(q, k, v, jmesh, "model", causal=causal,
                                                 flash=True, flash_block=FLASH_BLOCK)

        def loss(q, k, v):
            return jnp.sum(fn(q, k, v) * w)

        def run(f, *args):
            return jax.jit(f).lower(*args).compile({"xla_allow_excess_precision": False})(*args)

        want = [np.asarray(run(fn, q, k, v), np.float32)] + [
            np.asarray(g, np.float32) for g in run(jax.grad(loss, argnums=(0, 1, 2)), q, k, v)]
        results = ranks.get()
        sizes = {a: ULY_MESH[a] for a in ("data", "fsdp", "model")}
        for i, label in enumerate(("out", "dq", "dk", "dv")):
            got = np.zeros(ATTN_SHAPE, np.float32)
            for rank, res in enumerate(results):
                got[spmd.local_slices(ATTN_SPEC, ATTN_SHAPE, sizes, tsh._coords(sizes, rank))] = \
                    res["attention"][case][i]
            if dtype == torch.float32:
                tol = 1e-5
            else:
                tol = 3e-2 if label == "out" else tsh.ulps2(want[i])
            np.testing.assert_allclose(got, want[i], rtol=0, atol=tol, err_msg=f"{case} {label}")

    def test_divisibility_errors_are_the_references(self, ranks, devices):
        jmesh = jlogical(devices, **ULY_MESH)
        results = ranks.get()
        for name, shape in (("heads", (4, 64, 6, 16)), ("seq", (4, 30, 8, 16))):
            x = jnp.zeros(shape)
            with pytest.raises(ValueError) as want:
                jul.ulysses_attention_sharded(x, x, x, jmesh, "model")
            assert all(res["attention"][name] == str(want.value) for res in results), name


class TestGroupLocalRouting:
    """`moe_mlp_local` on one device against the reference's
    (tests/test_moe.py:234-291's cases), on the reference's weights."""

    SHAPE = dict(vocab=64, d_model=16, n_heads=4, d_ff=32, n_layers=1, seq=32, batch=8,
                 moe_experts=4)

    def both(self, capacity, seed=1):
        fields = dict(self.SHAPE, moe_capacity=capacity)
        jcfg, tcfg = jb.BurninConfig(**fields), tb.BurninConfig(**fields)
        jparams, tparams = both_params(jcfg, seed=seed)
        names = ("router", "w1e", "w2e")
        jlayer = {n: jparams["layers"][n][0] for n in names}
        tlayer = {n: tparams["layers"][n][0] for n in names}
        h = np.random.RandomState(seed + 1).randn(8, 32, 16).astype(np.float32)
        jh = jnp.asarray(h, jnp.bfloat16)
        th = torch.tensor(np.asarray(jh.astype(jnp.float32))).to(torch.bfloat16)
        return jcfg, tcfg, jlayer, tlayer, jh, th

    @pytest.mark.parametrize("capacity", [1.25, 0.5])
    @pytest.mark.parametrize("groups", [1, 2, 4])
    def test_matches_reference(self, groups, capacity):
        jcfg, tcfg, jlayer, tlayer, jh, th = self.both(capacity)
        want, want_aux = jmoe.moe_mlp_local(jlayer, jh, jcfg, lambda kind, a: a, groups)
        with route_margins() as margins:
            got, got_aux = tmoe.moe_mlp_local(tlayer, th, tcfg, groups)
        assert min(margins) > ROUTER_TIE, margins
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   **ULP_TOL)
        np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)

    def test_one_group_is_the_global_path(self):
        _, tcfg, _, tlayer, _, th = self.both(1.25)
        out, aux = tmoe.moe_mlp_local(tlayer, th, tcfg, 1)
        want, want_aux = tmoe.moe_mlp(tlayer, th, tcfg)
        assert torch.equal(out, want) and torch.equal(aux, want_aux)

    @pytest.mark.parametrize("groups", [2, 4])
    def test_ample_capacity_is_the_global_path(self, groups):
        """Capacity 4.0 never binds (every token to one expert fits), so
        the drop order is irrelevant and any grouping is the global path."""
        _, tcfg, _, tlayer, _, th = self.both(4.0, seed=3)
        out, aux = tmoe.moe_mlp_local(tlayer, th, tcfg, groups)
        want, want_aux = tmoe.moe_mlp(tlayer, th, tcfg)
        assert torch.equal(out, want)
        torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("groups", [2, 4])
    def test_dropping_is_per_group(self, groups):
        """Under capacity pressure a token is dropped (its output row
        zero) exactly when it is past its expert's capacity in its own
        group's queue, counted from the router's choices in numpy."""
        _, tcfg, _, tlayer, _, th = self.both(0.5)
        out, _ = tmoe.moe_mlp_local(tlayer, th, tcfg, groups)
        choice = tmoe.route(tlayer, th).argmax(-1).numpy()  # (B, S)
        cap = tmoe.expert_capacity(tcfg, groups=groups)
        B, S = choice.shape
        dropped = np.zeros((B, S), bool)
        for b in range(B):
            for g in range(groups):
                seen = {}
                for s in range(g * S // groups, (g + 1) * S // groups):
                    e = choice[b, s]
                    seen[e] = seen.get(e, 0) + 1
                    dropped[b, s] = seen[e] > cap
        assert dropped.any()
        np.testing.assert_array_equal(out.float().abs().sum(-1).numpy() == 0, dropped)
        global_out, _ = tmoe.moe_mlp(tlayer, th, tcfg)
        assert not torch.equal(out, global_out)


class TestLayout:
    @pytest.mark.parametrize("fields,mesh_kw", [
        (dict(ulysses_attention=True), tsh.MESH_3),
        (dict(ulysses_attention=True), ULY_MESH),
        (dict(ulysses_attention=True, flash_attention=True), tsh.MESH_3),
        (dict(ulysses_attention=True, flash_attention=True), tsh.MOE_MESH),
        (dict(ulysses_attention=True, moe_experts=4), tsh.MOE_MESH),
        (dict(ring_attention=True, moe_experts=4), tsh.MOE_MESH),
    ], ids=["ulysses-2x2x2", "ulysses-2x1x4", "ulysses_flash-2x2x2", "ulysses_flash-moe_mesh",
            "ulysses_moe-moe_mesh", "ring_moe-moe_mesh"])
    def test_scaled_config_and_specs_equal_the_references(self, devices, fields, mesh_kw):
        jmesh = tsh.jax_mesh(devices, mesh_kw)
        sizes = dict(jmesh.shape)
        jcfg = jb.BurninConfig(**fields).scaled_to(jmesh)
        tcfg = tb.BurninConfig(**fields).scaled_to(sizes)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tb.param_specs(tcfg, sizes) == tsh.TestLayout.specs_of(
            jb.param_specs(jcfg, jmesh))

    def test_long_context_moe_mesh_factors_as_the_references(self, devices):
        with pytest.raises(ValueError) as want:
            jmoe.moe_mesh(devices[:6], model=2, expert=2)
        with pytest.raises(ValueError) as got:
            tmodels.family_mesh("long_context_moe", range(6))
        assert str(got.value) == str(want.value)

    def test_ulysses_flash_degenerate_block_is_refused(self, devices):
        """``seq=100`` tiles to 4 positions: the reference's burn-in fails
        with its tiling message, and so does the port's block."""
        jmesh = jlogical(devices, **tsh.MESH_3)
        jcfg = jb.BurninConfig(ulysses_attention=True, flash_attention=True, seq=100)
        want = jb.train(jcfg, jmesh, steps=2)
        assert not want.ok and "seq % 8" in want.error
        tcfg = tb.BurninConfig(**dataclasses.asdict(jcfg.scaled_to(jmesh)))
        layer = {n: t[0] for n, t in tb.init_params(tcfg, device="cpu")["layers"].items()}

        class Place:
            sizes, coords, mesh = {"model": 2}, {"model": 0}, None

            def size(self, axis):
                return self.sizes.get(axis, 1)

            def index(self, axis):
                return 0

        specs = {n: s[1:] for n, s in tb.param_specs(tcfg, {"model": 2})["layers"].items()}
        x = torch.zeros((1, tcfg.seq // 2, tcfg.d_model))
        with pytest.raises(ValueError, match="seq % 8") as got:
            tb._block_sharded(layer, x, config=tcfg, place=Place(), specs=specs)
        assert str(got.value) == want.error.split(": ", 1)[1]


class TestServing:
    @pytest.mark.parametrize("fields", [dict(ulysses_attention=True),
                                        dict(ulysses_attention=True, flash_attention=True),
                                        dict(ring_attention=True, moe_experts=4)],
                             ids=["ulysses", "ulysses_flash", "ring_moe"])
    def test_cp_trained_config_serves_under_its_serving_view(self, fields):
        """The reference's tests/test_decode.py:570-591: the serving view
        strips the training-only parallelism and keeps the weights'
        geometry, so the cp-trained weights generate under it."""
        shape = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=32, batch=4)
        jcfg, tcfg = jb.BurninConfig(**shape, **fields), tb.BurninConfig(**shape, **fields)
        serving = td.serving_config(tcfg)
        assert dataclasses.asdict(serving) == dataclasses.asdict(jd.serving_config(jcfg))
        assert not serving.context_parallel
        params = tb.init_params(tcfg, device="cpu")
        fn = td.make_generate(serving, prompt_len=4, steps=4, with_health=True)
        toks, healthy = fn(params, torch.ones((4, 4), dtype=torch.int32))
        assert bool(healthy) and tuple(toks.shape) == (4, 8)
        with pytest.raises(ValueError) as got:
            td.make_generate(tcfg, prompt_len=4, steps=4)
        with pytest.raises(ValueError) as want:
            jd.make_generate(jcfg, prompt_len=4, steps=4)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("name", ["long_context", "long_context_a2a"])
    def test_serve_family_reports_the_references_refusal(self, name):
        want = jmodels.serve_family(name, [jax.devices()[0]], steps=4, prompt_len=8)
        got = tmodels.serve_family(name, steps=4, prompt_len=8, device="cpu")
        assert not got.ok and not want.ok
        assert got.error == want.error, (got.error, want.error)


class TestTraining:
    @pytest.mark.parametrize("name", sorted(TRAIN_CASES))
    def test_sharded_step_matches_the_references(self, ranks, devices, train_inputs, name,
                                                 monkeypatch):
        cfg, mesh_kw, state_np, tokens = train_inputs[name]
        jmesh = tsh.jax_mesh(devices, mesh_kw)
        want, want_moment = tsh.reference_run(cfg, jmesh, state_np, tokens, 3)
        # One device: full attention where the mesh ran the ring or the
        # swaps, and experts routed in the mesh's groups.
        single = dataclasses.replace(cfg, ring_attention=False, ulysses_attention=False)
        if cfg.moe_experts:
            groups = mesh_kw["model"]
            local_j, local_t = jmoe.moe_mlp_local, tmoe.moe_mlp_local
            monkeypatch.setattr(jmoe, "moe_mlp", lambda layer, h, config, constrain,
                                capacity=None: local_j(layer, h, config, constrain, groups))
            monkeypatch.setattr(tb, "moe_mlp", lambda layer, h, config, capacity=None:
                                local_t(layer, h, config, groups))
        _, single_moment = tsh.reference_run(single, None, state_np, tokens, 1)
        gap = jax.tree_util.tree_map(lambda a, b: a - b, want_moment, single_moment)

        tcfg = tb.BurninConfig(**dataclasses.asdict(cfg))
        results = ranks.get()
        got = results[0]["train"][name][0]
        assert all(res["train"][name][0] == got for res in results)  # one global loss
        if cfg.moe_experts:
            margins = [res["train"][f"{name} margin"] for res in results]
            print(f"{name}: smallest router top-2 margin {min(margins):.3e}")
            assert min(margins) > ROUTER_TIE, margins
        _, opt = tsh.weights.gather_state([res["train"][name][1] for res in results], tcfg,
                                          tsh._sizes(mesh_kw))
        np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
        np.testing.assert_allclose(got, want, rtol=1e-2)
        assert got[-1] < got[0]
        tsh.assert_grads_close(tsh._first_moment(opt), want_moment, gap, name)

        # The port's own single-device step on the same weights.
        tsingle = tb.BurninConfig(**dataclasses.asdict(single))
        step, _ = tb.make_train_step(tsingle, device="cpu")
        state = tsh.weights.state_from_numpy(state_np, tsingle, device="cpu")
        state, loss = step(state, torch.tensor(tokens))
        np.testing.assert_allclose(got[0], float(loss), rtol=1e-3)
        tsh.assert_grads_close(tsh._first_moment(opt),
                               tsh._numpy_tree(tsh._first_moment(state[1])), gap,
                               f"{name} vs the port's single-device step")


def test_routing_temp_comparison_is_none_off_cuda(ranks):
    """The activation bound reads the card's allocator: on the CPU ranks
    there is none, and every rank says so, as the reference's returns
    None without a memory analysis."""
    results = ranks.get()
    assert [res["bound"][0] for res in results] == [None] * WORLD
    # Both forms give the rank's block: 4 of the 8 batch rows (rows over
    # data only, repeated over expert), 256 of the 512 positions.
    assert [res["bound"][1] for res in results] == [((4, 256, 16), (4, 256, 16))] * WORLD
