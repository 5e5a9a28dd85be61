"""The port's sharded training (tpu_dra_torch/parallel/burnin.py on a
mesh, spmd.py, flash.flash_attention_sharded, ring.py, moe.py's mesh
forms, weights.shard_state/gather_state) against the reference's
(tpu_dra/parallel/burnin.py, flash.py, ring.py, moe.py) on its 8 virtual
CPU devices.

The port runs one process a rank, so its side runs in 8 gloo ranks,
spawned once for this module (`ranks`), each returning what it computed
on its shards; the parent puts the shards back together with
`weights.gather_state` (or, for attention, by `spmd.local_slices`) while
it compiles the reference's sharded programs.  The reference's steps are
compiled with ``xla_allow_excess_precision`` off, as in
tests/test_torch_train.py, and its flash kernel runs in Pallas interpret
mode, as its own tests run it; the port's on the CPU is its plain
version.  Every training case starts from the reference's own initial
state, cut into each rank's shards by `weights.shard_state`, on the same
numpy tokens.

Tolerances:

- specs, meshes and scaled configs: equal;
- attention (f32): outputs and the gradients of a fixed scalar within
  ``1e-5`` (the same f32 arithmetic, summed in another order);
- training: the first loss within ``rtol=1e-3`` of the reference's
  sharded step, three losses within ``rtol=1e-2``; each gradient leaf
  after step 1 (the momentum tree, or AdamW's first moment, which hold
  it) within 2 bf16 ulps of the leaf's largest magnitude, or, where the
  reference's own sharded and single-device steps differ by more than
  that on the leaf, within twice their gap (a sharded step rounds its
  bf16 partial sums per rank, which moves a gradient by more than its
  ulps when the sums cancel); the port's sharded step is held to its own
  single-device step on the same weights the same way."""

import dataclasses
import multiprocessing
import queue
import socket
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import flash as jflash
from tpu_dra.parallel import moe as jmoe
from tpu_dra.parallel import ring as jring
from tpu_dra.parallel.mesh import logical_mesh as jlogical
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import flash as tflash
from tpu_dra_torch.parallel import gang as tgang
from tpu_dra_torch.parallel import moe as tmoe
from tpu_dra_torch.parallel import ring as tring
from tpu_dra_torch.parallel import spmd, weights
from tpu_dra_torch.parallel.mesh import logical_mesh as tlogical

torch.set_num_threads(1)

WORLD = 8
# The reference's TINY (tests/test_burnin.py).
TINY = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, seq=16, batch=4)
MESH_3 = dict(data=2, fsdp=2, model=2)
MOE_MESH = dict(data=2, fsdp=1, model=2, expert=2)
TRAIN_CASES = {
    "dense": ({}, MESH_3),
    "flash": (dict(flash_attention=True), MESH_3),
    "rope_flash": (dict(rope=True, flash_attention=True), MESH_3),
    "moe": (dict(moe_experts=4), MESH_3),
    "moe_on_moe_mesh": (dict(moe_experts=4), MOE_MESH),
    "long_context": (dict(ring_attention=True), MESH_3),
    "adamw_clip": (dict(optimizer="adamw", grad_clip_norm=0.5, weight_decay=0.1), MESH_3),
}
ATTN_MODELS = (2, 4, 8)
ATTN_SHAPE = (8, 32, 8, 16)  # (b, s, h, d): b over data, h (flash) or s (ring) over model
ATTN_BLOCK = 16
# Specs of the attention inputs on (data, fsdp, model): the reference's
# shard_map specs (batch over the other axes, heads or sequence over model).
ATTN_SPECS = {"flash": (("data", "fsdp"), None, "model", None),
              "ring": (("data", "fsdp"), "model", None, None)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sizes(mesh_kw):
    return {a: mesh_kw[a] for a in ("data", "fsdp", "model", "expert") if a in mesh_kw}


def _coords(sizes, rank):
    return weights._coords(sizes, rank)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()  # a copy: the step updates the state in place


def _first_moment(opt):
    return opt["m"] if isinstance(opt, dict) and "t" in opt else opt


# --- what each rank runs ------------------------------------------------


def _rank_train(rank, cases):
    """Every training case on this rank's shards: the losses of 3 steps
    and the state after step 1."""
    out = {}
    for name, fields, mesh_kw, state_np, tokens in cases:
        mesh = tlogical(**mesh_kw)
        cfg = tb.BurninConfig(**fields)
        state = weights.shard_state(state_np, cfg, mesh, dist.get_rank(), device="cpu")
        place = spmd.Place(mesh)
        rows = torch.tensor(tokens[spmd.local_slices(tb.token_spec(cfg), tokens.shape,
                                                     place.sizes, place.coords)])
        step, _ = tb.make_train_step(cfg, mesh, with_state=False)
        losses, after_one = [], None
        for i in range(3):
            state, loss = step(state, rows)
            losses.append(float(loss))
            if i == 0:
                after_one = (_numpy_tree(state[0]), _numpy_tree(state[1]))
        out[name] = (losses, after_one)
    return out


def _rank_attention(rank, inputs):
    """flash_attention_sharded and ring_attention_sharded at each model
    size: the rank's output block and the gradients of sum(out * w)."""
    out = {}
    q, k, v, w = inputs
    for m in ATTN_MODELS:
        mesh = tlogical(data=WORLD // m, fsdp=1, model=m)
        place = spmd.Place(mesh)
        for kind, spec in ATTN_SPECS.items():
            sl = spmd.local_slices(spec, q.shape, place.sizes, place.coords)
            qkv = [torch.tensor(a[sl]).requires_grad_() for a in (q, k, v)]
            if kind == "flash":
                o = tflash.flash_attention_sharded(*qkv, mesh, "model", block_q=ATTN_BLOCK,
                                                   block_k=ATTN_BLOCK)
            else:
                o = tring.ring_attention_sharded(*qkv, mesh, "model")
            grads = torch.autograd.grad((o * torch.tensor(w[sl])).sum(), qkv)
            out[(kind, m)] = [o.detach().numpy()] + [g.numpy() for g in grads]
    return out


def _rank_main(rank, init_method, jobs_in, out):
    torch.set_num_threads(1)
    results = {}
    try:
        jobs = jobs_in.get(timeout=240)
        tgang.join_group(init_method, world_size=WORLD, rank=rank, device="cpu", timeout_s=240)
        for name, fn, args in jobs:
            results[name] = fn(rank, args)
    except Exception:  # reported, so the test names the failing rank
        results["error"] = traceback.format_exc()
    finally:
        out.put((rank, results))
        if dist.is_initialized():
            dist.destroy_process_group()


# --- the reference's side -----------------------------------------------


def jax_mesh(devices, mesh_kw):
    if "expert" in mesh_kw:
        return jmoe.moe_mesh(devices, **mesh_kw)
    return jlogical(devices, **mesh_kw)


def compiled(step, state, tokens):
    return step.lower(state, tokens).compile({"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, "conftest must provide 8 virtual CPU devices"
    return devs


@pytest.fixture(scope="module")
def train_inputs(devices):
    """Each case's scaled config, the reference's initial state as numpy
    and the tokens."""
    cases = {}
    for name, (overrides, mesh_kw) in TRAIN_CASES.items():
        cfg = jb.BurninConfig(**TINY, **overrides).scaled_to(jax_mesh(devices, mesh_kw))
        state = jax.tree_util.tree_map(np.asarray, jb._init_state(cfg))
        tokens = np.random.RandomState(3).randint(0, cfg.vocab, (cfg.batch, cfg.seq)).astype(
            np.int32)
        cases[name] = (cfg, mesh_kw, state, tokens)
    return cases


@pytest.fixture(scope="module")
def attn_inputs():
    rng = np.random.RandomState(5)
    return tuple(rng.randn(*ATTN_SHAPE).astype(np.float32) for _ in range(4))


class Ranks:
    """The module's 8 gloo ranks, started at once and waited for at the
    first `get` (the parent compiles the reference meanwhile)."""

    def __init__(self, jobs):
        ctx = multiprocessing.get_context("spawn")
        self.out, self.jobs_in = ctx.Queue(), ctx.Queue()
        init = f"tcp://127.0.0.1:{_free_port()}"
        self.procs = [ctx.Process(target=_rank_main, args=(r, init, self.jobs_in, self.out),
                                  daemon=True) for r in range(WORLD)]
        for p in self.procs:
            p.start()
        # The jobs go through a queue, not the arguments: a start that
        # pickles them waits for each child to import this module first.
        for _ in range(WORLD):
            self.jobs_in.put(jobs)
        self.results = None

    def get(self):
        if self.results is None:
            got = {}
            deadline = time.monotonic() + 400
            try:
                while len(got) < WORLD and time.monotonic() < deadline:
                    try:
                        rank, res = self.out.get(timeout=1)
                    except queue.Empty:
                        dead = [r for r, p in enumerate(self.procs)
                                if p.exitcode is not None and r not in got]
                        assert not dead, f"ranks {dead} exited without a result"
                        continue
                    got[rank] = res
            finally:
                self.stop()
            assert len(got) == WORLD, f"ranks {sorted(set(range(WORLD)) - set(got))} timed out"
            errors = {r: res["error"] for r, res in got.items() if "error" in res}
            assert not errors, errors
            self.results = [got[r] for r in range(WORLD)]
        return self.results

    def stop(self):
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def ranks(train_inputs, attn_inputs):
    cases = [(name, dataclasses.asdict(cfg), mesh_kw, state, tokens)
             for name, (cfg, mesh_kw, state, tokens) in train_inputs.items()]
    r = Ranks([("train", _rank_train, cases), ("attention", _rank_attention, attn_inputs)])
    yield r
    r.stop()


def ulps2(want):
    """2 bf16 ulps at the largest magnitude of ``want``."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def reference_run(jcfg, mesh, state_np, tokens, steps):
    """The reference's step on ``mesh`` (None: one device): its losses
    and its first moment after step 1, as numpy."""
    step, _ = jb.make_train_step(jcfg, mesh, with_state=False)
    state = jax.tree_util.tree_map(jnp.asarray, state_np)
    tok = jnp.asarray(tokens)
    if mesh is not None:
        state = jax.device_put(state, jb.state_shardings(jcfg, mesh))
        tok = jax.device_put(tok, jax.sharding.NamedSharding(mesh, jb.token_spec(jcfg)))
    step = compiled(step, state, tok)
    losses, moment = [], None
    for i in range(steps):
        state, loss = step(state, tok)
        losses.append(float(loss))
        if i == 0:
            moment = jax.tree_util.tree_map(np.asarray, _first_moment(state[1]))
    return losses, moment


def assert_grads_close(got, want, gap, label):
    """Each leaf within 2 bf16 ulps of its largest magnitude, or twice the
    reference's own sharded-vs-one-device gap on it."""
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    flat_gap = jax.tree_util.tree_leaves(gap)
    assert len(flat_w) == len(flat_g) == len(flat_gap)
    for (path, w), g, d in zip(flat_w, flat_g, flat_gap):
        assert g.shape == w.shape, (label, path)
        tol = max(ulps2(w), 2 * float(np.abs(d).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{label} {jax.tree_util.keystr(path)}")


class TestLayout:
    MESHES = [dict(data=2, fsdp=2, model=2), dict(data=8, fsdp=1, model=1),
              dict(data=2, fsdp=1, model=4), dict(data=1, fsdp=1, model=1)]
    CONFIGS = {"dense": {}, "flash": dict(flash_attention=True),
               "rope": dict(rope=True, flash_attention=True), "moe": dict(moe_experts=4),
               "long_context": dict(ring_attention=True)}

    @staticmethod
    def specs_of(tree):
        return jax.tree_util.tree_map(
            lambda s: tuple(s), tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))

    @pytest.mark.parametrize("mesh_kw", MESHES, ids=lambda m: "x".join(map(str, m.values())))
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_scaled_config_and_specs_equal_the_references(self, devices, name, mesh_kw):
        n = mesh_kw["data"] * mesh_kw["fsdp"] * mesh_kw["model"]
        jmesh = jlogical(devices[:n], **mesh_kw)
        jcfg = jb.BurninConfig(**self.CONFIGS[name]).scaled_to(jmesh)
        tcfg = tb.BurninConfig(**self.CONFIGS[name]).scaled_to(_sizes(mesh_kw))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tb.param_specs(tcfg, _sizes(mesh_kw)) == self.specs_of(jb.param_specs(jcfg, jmesh))
        assert tb.token_spec(tcfg) == tuple(jb.token_spec(jcfg))
        want = jax.tree_util.tree_map(lambda a: a.shape, jb.init_params(jcfg))
        got = jax.tree_util.tree_map(lambda t: tuple(t.shape), tb.init_params(tcfg, device="cpu"))
        assert got == want

    @pytest.mark.parametrize("mesh_kw", [dict(model=2, expert=2), dict(model=1, expert=4),
                                         dict(model=2, expert=1)],
                             ids=["m2e2", "m1e4", "m2e1"])
    def test_moe_mesh_config_and_specs_equal_the_references(self, devices, mesh_kw):
        jmesh = jmoe.moe_mesh(devices, **mesh_kw)
        sizes = dict(jmesh.shape)
        assert list(sizes) == ["data", "fsdp", "model", "expert"]
        jcfg = jb.BurninConfig(moe_experts=4).scaled_to(jmesh)
        tcfg = tb.BurninConfig(moe_experts=4).scaled_to(sizes)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tb.param_specs(tcfg, sizes) == self.specs_of(jb.param_specs(jcfg, jmesh))

    @pytest.mark.parametrize("axis,ring", [("model", False), ("expert", False), ("expert", True),
                                           ("model", True)])
    def test_moe_param_specs_equal_the_references(self, axis, ring):
        assert tmoe.moe_param_specs(axis, ring=ring) == self.specs_of(
            jmoe.moe_param_specs(axis, ring=ring))

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
    def test_burnin_mesh_shape(self, devices, n):
        """`burnin_mesh`'s factorization is the reference's (the port's
        mesh itself needs a process group: the validate and family tests
        build it in gloo ranks)."""
        model = tb._pow2_divisor(n, cap=2)
        fsdp = tb._pow2_divisor(n // model, cap=2)
        got = {"data": n // (model * fsdp), "fsdp": fsdp, "model": model}
        assert got == dict(jb.burnin_mesh(devices[:n]).shape)

    def test_state_shardings_cover_the_state(self):
        cfg = tb.BurninConfig(optimizer="adamw", moe_experts=4).scaled_to(MESH_3)
        specs = tb.state_shardings(cfg, MESH_3)
        state = tb._init_state(cfg, "cpu")
        for leaf, spec in zip(tb._leaves(state[0]) + tb._leaves(state[1]["m"]),
                              tb._leaves(specs[0]) + tb._leaves(specs[1]["m"])):
            assert len(spec) == leaf.dim()
        assert specs[1]["t"] == ()

    def test_shard_state_round_trips(self, train_inputs):
        cfg, mesh_kw, state, _ = train_inputs["adamw_clip"]
        tcfg = tb.BurninConfig(**dataclasses.asdict(cfg))
        sizes = _sizes(mesh_kw)
        shards = [weights.shard_state(state, tcfg, sizes, r, device="cpu") for r in range(WORLD)]
        embed = shards[5][0]["embed"]
        assert tuple(embed.shape) == (cfg.vocab // 2, cfg.d_model // 2) and embed.is_contiguous()
        back = weights.gather_state(shards, tcfg, sizes)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, state)

    def test_cp_without_a_mesh_is_refused_with_the_references_message(self):
        cfg = tb.BurninConfig(ring_attention=True, **TINY)
        params = tb.init_params(cfg, device="cpu")
        with pytest.raises(ValueError) as got:
            tb.forward(params, torch.zeros((1, TINY["seq"]), dtype=torch.int32), cfg)
        jcfg = jb.BurninConfig(ring_attention=True, **TINY)
        with pytest.raises(ValueError) as want:
            jb.forward(jb.init_params(jcfg), jnp.zeros((1, TINY["seq"]), jnp.int32), jcfg)
        assert str(got.value) == str(want.value) == \
            "context-parallel attention requires a device mesh"

    @pytest.mark.parametrize("fields", [dict(ring_attention=True, flash_attention=True),
                                        dict(ring_attention=True, rope=True),
                                        dict(ring_attention=True, moe_experts=4)],
                             ids=["ring_flash", "ring_rope", "ring_moe"])
    def test_cp_refusals_are_the_references(self, devices, fields):
        jmesh = jlogical(devices, data=2, fsdp=2, model=2)
        jcfg = jb.BurninConfig(**TINY, **fields).scaled_to(jmesh)
        with pytest.raises(ValueError) as want:
            jb.forward(jb.init_params(jcfg), jnp.zeros((jcfg.batch, jcfg.seq), jnp.int32), jcfg,
                       jmesh)
        with pytest.raises(ValueError) as got:
            tb._check_parallelism(tb.BurninConfig(**dataclasses.asdict(jcfg)), MESH_3)
        assert str(got.value) == str(want.value)

    def test_ulysses_and_pipeline_stay_refused_by_name(self):
        """Both are ported: each config is accepted as the reference's is,
        and a pipeline without a (data, pipe, model) mesh is refused with
        the reference's message (tests/test_torch_pipeline.py holds the
        pipeline itself)."""
        jcfg = jb.BurninConfig(pipeline_stages=2, **TINY)
        with pytest.raises(ValueError) as want:
            jb.forward(jb.init_params(jcfg), jnp.zeros((1, TINY["seq"]), jnp.int32), jcfg)
        cfg = tb.BurninConfig(pipeline_stages=2, **TINY)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        with pytest.raises(ValueError) as got:
            tb.forward(tb.init_params(cfg, device="cpu"),
                       torch.zeros((1, TINY["seq"]), dtype=torch.int32), cfg)
        assert str(got.value) == str(want.value).replace("tpu_dra.", "tpu_dra_torch.")
        cfg = tb.BurninConfig(ulysses_attention=True)
        assert cfg.context_parallel
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jb.BurninConfig(ulysses_attention=True))


class _TwoRanks:
    """A place on a 2-rank ``model`` axis whose collectives the tests fake."""

    sizes, coords = {"model": 2}, {"model": 0}

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        return None


class TestCollectivesHandNcclContiguousTensors:
    """NCCL refuses a non-contiguous tensor ("Tensors must be contiguous");
    gloo takes one, so the ranks' tests cannot show it.  The collectives
    are run here against fakes that check what they are handed (the
    all-reduce of two equal ranks doubles its tensor)."""

    def test_psum_of_a_permuted_view(self, monkeypatch):
        def all_reduce(t, group=None):
            assert t.is_contiguous()
            t.mul_(2)

        monkeypatch.setattr(dist, "all_reduce", all_reduce)
        base = torch.randn(3, 4, 5)
        x = base.permute(2, 0, 1).requires_grad_()
        out = spmd.psum(x, _TwoRanks(), "model")
        torch.testing.assert_close(out, 2 * x.detach())
        (g,) = torch.autograd.grad(out, x, torch.ones_like(out).permute(0, 2, 1).contiguous()
                                   .permute(0, 2, 1))
        torch.testing.assert_close(g, torch.full_like(g, 2.0))
        assert torch.equal(x.detach(), base.permute(2, 0, 1))  # the input is not written

    def test_all_to_all_of_a_permuted_view(self, monkeypatch):
        """The all-to-all of a permuted view, and its backward, hand NCCL
        contiguous send and receive buffers (the fake exchanges nothing:
        two ranks of equal blocks, each sending itself its own chunks)."""
        def all_to_all_single(out, inp, group=None):
            assert inp.is_contiguous() and out.is_contiguous()
            out.copy_(inp)

        monkeypatch.setattr(dist, "all_to_all_single", all_to_all_single)
        base = torch.randn(4, 6, 2, 3)
        x = base.permute(1, 0, 3, 2).requires_grad_()  # (6, 4, 3, 2)
        out = spmd.all_to_all(x, _TwoRanks(), "model", split_dim=1, concat_dim=0)
        assert out.shape == (12, 2, 3, 2) and out.is_contiguous()
        torch.testing.assert_close(out, torch.cat(x.detach().chunk(2, dim=1), dim=0))
        g = torch.randn(2, 12, 3, 2).transpose(0, 1)  # a non-contiguous cotangent
        (back,) = torch.autograd.grad(out, x, g)
        torch.testing.assert_close(back, torch.cat(g.chunk(2, dim=0), dim=1))

    def test_shift_receives_into_contiguous_buffers(self, monkeypatch):
        handed = []

        class Op:
            def __init__(self, fn, t, peer, group):
                handed.append(t)
                self.fn, self.t = fn, t

        def batch(ops):
            sent = [op.t for op in ops if op.fn is dist.isend]
            for op, t in zip([op for op in ops if op.fn is dist.irecv], sent):
                op.t.copy_(t)
            return []

        monkeypatch.setattr(dist, "P2POp", Op)
        monkeypatch.setattr(dist, "batch_isend_irecv", batch)
        monkeypatch.setattr(dist, "get_global_rank", lambda group, r: r)
        x = torch.randn(4, 6).t()
        (out,) = spmd.shift([x], _TwoRanks(), "model")
        assert all(t.is_contiguous() for t in handed)
        assert torch.equal(out, x)


class TestAttention:
    @pytest.mark.parametrize("model", ATTN_MODELS)
    @pytest.mark.parametrize("kind", sorted(ATTN_SPECS))
    def test_output_and_gradients_equal_the_references(self, ranks, devices, attn_inputs,
                                                       kind, model):
        q, k, v, w = (jnp.asarray(a) for a in attn_inputs)
        jmesh = jlogical(devices, data=WORLD // model, fsdp=1, model=model)
        if kind == "flash":
            def fn(q, k, v):
                return jflash.flash_attention_sharded(q, k, v, jmesh, "model",
                                                      block_q=ATTN_BLOCK, block_k=ATTN_BLOCK)
        else:
            def fn(q, k, v):
                return jring.ring_attention_sharded(q, k, v, jmesh, "model", causal=True)
        want_out = np.asarray(jax.jit(fn)(q, k, v))
        want_grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w),
                                      argnums=(0, 1, 2)))(q, k, v)
        want = [want_out] + [np.asarray(g) for g in want_grads]
        got = [np.zeros_like(a) for a in want]
        sizes = {"data": WORLD // model, "fsdp": 1, "model": model}
        for rank, res in enumerate(ranks.get()):
            sl = spmd.local_slices(ATTN_SPECS[kind], ATTN_SHAPE, sizes, _coords(sizes, rank))
            for g, part in zip(got, res["attention"][(kind, model)]):
                g[sl] = part
        for label, g, wnt in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, wnt, rtol=0, atol=1e-5, err_msg=f"{kind} {label}")

    def test_ring_on_one_rank_is_the_oracle(self, attn_inputs):
        """With one rank the ring is one fold: its output and gradients
        against `reference_attention`'s autograd, in one process."""
        q, k, v, w = (torch.tensor(a) for a in attn_inputs)

        class OneRank:
            sizes, coords = {"model": 1}, {"model": 0}

            def size(self, axis):
                return 1

            def index(self, axis):
                return 0

        outs = []
        for fn in (lambda *t: tring.ring_attention(*t, OneRank(), "model"),
                   lambda *t: tring.reference_attention(*t, causal=True)):
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fn(*qkv)
            outs.append([o.detach()] + list(torch.autograd.grad((o * w).sum(), qkv)))
        for a, b in zip(*outs):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


class TestTraining:
    @pytest.mark.parametrize("name", sorted(TRAIN_CASES))
    def test_sharded_step_matches_the_references(self, ranks, devices, train_inputs, name):
        cfg, mesh_kw, state_np, tokens = train_inputs[name]
        jmesh = jax_mesh(devices, mesh_kw)
        want, want_moment = reference_run(cfg, jmesh, state_np, tokens, 3)
        # The reference on one device: dense attention where the ring ran.
        single = dataclasses.replace(cfg, ring_attention=False)
        _, single_moment = reference_run(single, None, state_np, tokens, 1)
        gap = jax.tree_util.tree_map(lambda a, b: a - b, want_moment, single_moment)

        tcfg = tb.BurninConfig(**dataclasses.asdict(cfg))
        results = ranks.get()
        got = results[0]["train"][name][0]
        assert all(res["train"][name][0] == got for res in results)  # one global loss
        sizes = _sizes(mesh_kw)
        _, opt = weights.gather_state([res["train"][name][1] for res in results], tcfg, sizes)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
        np.testing.assert_allclose(got, want, rtol=1e-2)
        assert got[-1] < got[0]
        assert_grads_close(_first_moment(opt), want_moment, gap, name)

        # The port's own single-device step on the same weights.
        tsingle = tb.BurninConfig(**dataclasses.asdict(single))
        step, _ = tb.make_train_step(tsingle, device="cpu")
        state = weights.state_from_numpy(state_np, tsingle, device="cpu")
        state, loss = step(state, torch.tensor(tokens))
        np.testing.assert_allclose(got[0], float(loss), rtol=1e-3)
        assert_grads_close(_first_moment(opt), _numpy_tree(_first_moment(state[1])), gap,
                           f"{name} vs the port's single-device step")
