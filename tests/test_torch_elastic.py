"""The mesh forms of the port's input pipeline and checkpoints
(tpu_dra_torch/parallel/data.py and ckpt.py with ``mesh=``), and elastic
resume, against the reference's (tpu_dra/parallel/data.py, ckpt.py) on
its 8 virtual CPU devices.

The port's side runs in 8 gloo ranks spawned once for this module
(`test_torch_sharded.Ranks`), in a temporary directory the parent hands
them.  A resume on a smaller mesh runs on host blocks of the same group
(`mesh.logical_mesh` of a block of ranks: ranks 0-3 and 4-7 each form a
(data 1, fsdp 2, model 2) mesh, each in its own copy of the directory;
ranks 0-7 each a one-rank mesh), so no second group is spawned.  Runs
held to the reference start from the reference's own initial state
(`weights.shard_state`) on the reference's batch (`burnin.sample_tokens`
with the reference's key), the reference's steps jitted as its own
``train_on_stream`` and ``train_with_resume`` jit them.

Tolerances:

- prefetched batches, checkpoint round trips (the same mesh, one device
  and back, a fall-back) and a one-rank mesh against one device:
  bitwise;
- the stream-fed trainer on a mesh against the reference's: the first
  and last losses within ``rtol=1e-2``, as tests/test_torch_data.py
  holds the one-device trainer (the reference's step here is its own
  jitted one, excess precision and all);
- elastic resume: the resumed losses within ``rtol=2e-3`` of the
  uninterrupted run's (the reference's own bound, tests/test_ckpt.py),
  every loss within ``rtol=1e-2`` of the reference's elastic run, and
  the two host blocks' resumed losses equal;
- refusals: the reference's words."""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_sharded as tsh
from tpu_dra.parallel import burnin as jb
from tpu_dra.parallel import ckpt as jc
from tpu_dra.parallel import data as jd
from tpu_dra.parallel import pipeline as jpipe
from tpu_dra.parallel.mesh import logical_mesh as jlogical
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import ckpt as tc
from tpu_dra_torch.parallel import data as td
from tpu_dra_torch.parallel import pipeline as tpipe
from tpu_dra_torch.parallel import prng, spmd, weights
from tpu_dra_torch.parallel.mesh import logical_mesh as tlogical

torch.set_num_threads(1)

WORLD = 8
# tests/test_ckpt.py's SMALL: divisible by (data 2, fsdp 2, model 2) as it is.
SMALL = dict(n_layers=1, seq=32, d_model=32, d_ff=64, n_heads=4, batch=8, vocab=64)
MESH_3 = dict(data=2, fsdp=2, model=2)
HALF = dict(data=1, fsdp=2, model=2)
PIPE = dict(stages=2, model=2)
STREAM_CASES = {"dense": (dict(SMALL), "mesh"), "adamw": (dict(SMALL, optimizer="adamw"), "mesh"),
                "pipelined": (dict(SMALL, n_layers=2, pipeline_stages=2, moe_experts=2), "pipe")}
STREAM_STEPS = 4


def _mesh(kind):
    return tpipe.pipeline_mesh(**PIPE) if kind == "pipe" else tlogical(**MESH_3)


def _leaves(state):
    return [t.clone() for t in tb._leaves(state[0]) + tb._leaves(state[1])]


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and x.shape == y.shape
                                      and torch.equal(x, y) for x, y in zip(la, lb))


def _reference_tokens(config, device):
    """The reference's ``prepare_tokens`` batch (its default key 42), on
    ``device`` or this rank's rows of it on a mesh."""
    mesh, dev = tb._placement(device, "cpu")
    tokens = tb.sample_tokens(config, device="cpu", key=prng.key(42))
    if mesh is None:
        return tokens
    place = spmd.Place(mesh)
    return tokens[spmd.local_slices(tb.token_spec(config), tokens.shape, place.sizes,
                                    place.coords)].contiguous()


class _FromReference:
    """`make_train_step` whose fresh state is the reference's
    ``state_np`` (this rank's shards of it on a mesh)."""

    def __init__(self, real, state_np):
        self.real, self.state_np = real, state_np

    def __call__(self, config, target, with_state=True):
        step, _ = self.real(config, target, with_state=False)
        if not with_state:
            return step, None
        if isinstance(target, str):
            return step, weights.state_from_numpy(self.state_np, config, device=target)
        return step, weights.shard_state(self.state_np, config, target, dist.get_rank(),
                                         device="cpu")


# --- what each rank runs ------------------------------------------------


def _rank_prefetch(rank, batches):
    """Each batch as `prefetch_to_device` hands it out on a mesh, for the
    training layout of each mesh flavor and for a spec of None."""
    out = {}
    for kind, spec in (("mesh", tb.token_spec(tb.BurninConfig())),
                       ("pipe", tb.token_spec(tb.BurninConfig(pipeline_stages=2))),
                       ("mesh whole", None)):
        mesh = _mesh(kind.split()[0])
        pf = td.prefetch_to_device(iter(batches), size=2, device="cpu", mesh=mesh, spec=spec)
        out[kind] = [b.numpy().copy() for b in pf]
    return out


def _rank_stream(rank, cases):
    """`train_on_stream` on the mesh from the reference's initial state."""
    out = {}
    real = td.make_train_step
    for name, fields, kind, state_np in cases:
        td.make_train_step = _FromReference(real, state_np)
        try:
            out[name] = dataclasses.asdict(
                td.train_on_stream(tb.BurninConfig(**fields), _mesh(kind), steps=STREAM_STEPS,
                                   seed=1, device="cpu"))
        finally:
            td.make_train_step = real
    return out


def _rank_ckpt(rank, root):
    """Round trips on (data 2, fsdp 2, model 2): the same mesh, one
    device and back; the agreed fall-back; a one-rank mesh against one
    device both ways."""
    out = {}
    mesh = tlogical(**MESH_3)
    cfg = tb.BurninConfig(**dict(SMALL, optimizer="adamw")).scaled_to(mesh)
    step, state = tb.make_train_step(cfg, mesh)
    tokens = tb.prepare_tokens(cfg, mesh)
    path = os.path.join(root, "round")
    state, _ = step(state, tokens)
    one_step = _leaves(state)
    tc.save_state(path, state, step=1, mesh=mesh, config=cfg)
    state, _ = step(state, tokens)
    tc.save_state(path, state, step=2, mesh=mesh, config=cfg)
    out["files"] = sorted(os.listdir(os.path.join(path, "2")))
    out["same mesh"] = _equal(tc.restore_state(path, cfg, mesh, step=2), state)
    whole = tc.restore_state(path, cfg, step=2, device="cpu")
    out["whole"] = tb._tree_map(lambda t: t.numpy().copy(), whole[0])
    out["shards"] = tb._tree_map(lambda t: t.detach().numpy().copy(), state[0])
    back = os.path.join(root, "back")
    if rank == 0:
        tc.save_state(back, whole, step=2)  # one device's checkpoint
    dist.barrier()
    out["one device and back"] = _equal(tc.restore_state(back, cfg, mesh), state)

    # One rank's restore of step 2 fails: every rank falls back to step 1.
    real = tc._restore_step

    def failing(path_, config, dev, s, place=None):
        if s == 2 and dist.get_rank() == 3:
            raise OSError("a torn read")
        return real(path_, config, dev, s, place)

    tc._restore_step = failing
    try:
        fell = tc.restore_state(path, cfg, mesh)
    finally:
        tc._restore_step = real
    out["fall-back agreed"] = [torch.equal(a, b) for a, b in zip(_leaves(fell), one_step)]
    # A shard file torn away on disk, and a save killed midway: step 1.
    dist.barrier()
    if rank == 0:
        os.remove(os.path.join(path, "2", tc.SHARD_FILE.format(5, WORLD)))
        os.makedirs(os.path.join(path, ".tmp.9.deadbeef"))
    dist.barrier()
    out["torn file"] = all(torch.equal(a, b) for a, b in zip(_leaves(tc.restore_state(
        path, cfg, mesh)), one_step))
    try:
        tc.restore_state(path, cfg, mesh, step=2)
        out["explicit torn step"] = "restored"
    except FileNotFoundError as e:
        out["explicit torn step"] = str(e)

    # A one-rank mesh (each rank its own, in its own directory) against
    # one device: interrupted on the mesh and resumed on one device, and
    # the reverse, bitwise the uninterrupted runs'.
    solo = tlogical([rank], data=1, fsdp=1, model=1)
    mine = os.path.join(root, f"solo{rank}")
    small = tb.BurninConfig(**SMALL)
    _, full = tc.train_with_resume(small, os.path.join(mine, "full"), steps=4, device="cpu")
    _, a = tc.train_with_resume(small, os.path.join(mine, "m2d"), solo, steps=2)
    _, b = tc.train_with_resume(small, os.path.join(mine, "m2d"), steps=2, device="cpu")
    _, c = tc.train_with_resume(small, os.path.join(mine, "d2m"), steps=2, device="cpu")
    _, d = tc.train_with_resume(small, os.path.join(mine, "d2m"), solo, steps=2)
    out["one-rank mesh"] = (full, a + b, c + d)
    return out


def _rank_elastic(rank, args):
    """The reference's elastic stanza on the port: 5 uninterrupted steps
    on (data 2, fsdp 2, model 2); 3 steps saved each step, then 2 resumed
    on (data 1, fsdp 2, model 2) — ranks 0-3 in the directory, ranks 4-7
    in a copy; then an incompatible resize."""
    root, state_np = args
    real_step, real_tokens = tc.make_train_step, tc.prepare_tokens
    tc.make_train_step = _FromReference(real_step, state_np)
    tc.prepare_tokens = _reference_tokens
    out = {}
    try:
        small = tb.BurninConfig(**SMALL)
        mesh8 = tlogical(**MESH_3)
        _, out["full"] = tc.train_with_resume(small, os.path.join(root, "full"), mesh8, steps=5,
                                              save_every=100)
        path = os.path.join(root, "elastic")
        _, out["first"] = tc.train_with_resume(small, path, mesh8, steps=3, save_every=1)
        dist.barrier()
        if rank == 0:
            shutil.copytree(path, path + "_copy")
        dist.barrier()
        block = list(range(4)) if rank < 4 else list(range(4, 8))
        mesh4 = tlogical(block, **HALF)
        out["second"] = tc.train_with_resume(small, path if rank < 4 else path + "_copy", mesh4,
                                             steps=2, save_every=1)
        dist.barrier()
        out["mesh4"] = spmd.mesh_sizes(mesh4)
        run = os.path.join(root, "resize")
        tc.train_with_resume(small, run, tlogical(data=8, fsdp=1, model=1), steps=1, save_every=1)
        try:
            tc.train_with_resume(small, run, tlogical(data=1, fsdp=1, model=8), steps=1,
                                 save_every=1)
            out["resize"] = "no error"
        except ValueError as e:
            out["resize"] = str(e)
    finally:
        tc.make_train_step, tc.prepare_tokens = real_step, real_tokens
    return out


# --- the reference's side -----------------------------------------------


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, "conftest must provide 8 virtual CPU devices"
    return devs


@pytest.fixture(scope="module")
def batches():
    return [np.random.RandomState(i).randint(0, 64, (8, 16)).astype(np.int32) for i in range(5)]


def _jmesh(devices, kind):
    return (jpipe.pipeline_mesh(devices, **PIPE) if kind == "pipe"
            else jlogical(devices, **MESH_3))


@pytest.fixture(scope="module")
def stream_cases(devices):
    cases = {}
    for name, (fields, kind) in STREAM_CASES.items():
        cfg = jb.BurninConfig(**fields).scaled_to(_jmesh(devices, kind))
        cases[name] = (fields, kind, jax.tree_util.tree_map(np.asarray, jb._init_state(cfg)))
    return cases


@pytest.fixture(scope="module")
def elastic_state(devices):
    cfg = jb.BurninConfig(**SMALL).scaled_to(jlogical(devices, **MESH_3))
    return jax.tree_util.tree_map(np.asarray, jb._init_state(cfg))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic"))


@pytest.fixture(scope="module")
def ranks(batches, stream_cases, elastic_state, root):
    r = tsh.Ranks([
        ("prefetch", _rank_prefetch, batches),
        ("stream", _rank_stream, [(n, f, k, s) for n, (f, k, s) in stream_cases.items()]),
        ("ckpt", _rank_ckpt, os.path.join(root, "port")),
        ("elastic", _rank_elastic, (os.path.join(root, "port_elastic"), elastic_state)),
    ])
    yield r
    r.stop()


class TestPrefetch:
    @pytest.mark.parametrize("kind", ["mesh", "pipe", "mesh whole"])
    def test_each_rank_gets_its_slices_of_the_host_batch(self, ranks, batches, kind):
        sizes = (tpipe.pipeline_sizes(WORLD, **PIPE) if kind == "pipe"
                 else dict(MESH_3))
        spec = {"mesh": (("data", "fsdp"), None), "pipe": ("data", None),
                "mesh whole": (None, None)}[kind]
        for rank, res in enumerate(ranks.get()):
            got = res["prefetch"][kind]
            assert len(got) == len(batches)
            for g, b in zip(got, batches):
                want = b[spmd.local_slices(spec, b.shape, sizes, tsh._coords(sizes, rank))]
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, want)


class TestTrainOnStream:
    @pytest.mark.parametrize("name", sorted(STREAM_CASES))
    def test_matches_the_references_on_the_mesh(self, ranks, devices, stream_cases, name):
        fields, kind, state = stream_cases[name]
        jmesh = _jmesh(devices, kind)
        real = jd.make_train_step

        def from_state(config, mesh):
            step, _ = real(config, mesh, with_state=False)
            return step, jax.device_put(jax.tree_util.tree_map(jax.numpy.asarray, state),
                                        jb.state_shardings(config, mesh))

        jd.make_train_step = from_state
        try:
            want = jd.train_on_stream(jb.BurninConfig(**fields), jmesh, steps=STREAM_STEPS, seed=1)
        finally:
            jd.make_train_step = real
        reports = [res["stream"][name] for res in ranks.get()]
        got = reports[0]
        # The verdict is the reference's (the pipelined MoE case does not
        # descend over 4 distinct batches on either side).
        assert got["ok"] == want.ok and got["error"] == want.error == "", (want, got)
        assert all((r["loss_first"], r["loss_last"]) == (got["loss_first"], got["loss_last"])
                   for r in reports)
        assert got["steps"] == want.steps == STREAM_STEPS
        np.testing.assert_allclose([got["loss_first"], got["loss_last"]],
                                   [want.loss_first, want.loss_last], rtol=1e-2)

    def test_a_pipelined_config_needs_a_pipe_mesh(self):
        fields = STREAM_CASES["pipelined"][0]
        want = jd.train_on_stream(jb.BurninConfig(**fields), steps=2)
        got = td.train_on_stream(tb.BurninConfig(**fields), steps=2, device="cpu")
        assert not want.ok and not got.ok
        assert got.error == want.error.replace("tpu_dra.", "tpu_dra_torch.")


class TestCheckpoints:
    def test_every_rank_writes_its_own_shard(self, ranks):
        files = ranks.get()[0]["ckpt"]["files"]
        assert files == [tc.COMPLETE_MARKER] + sorted(
            tc.SHARD_FILE.format(i, WORLD) for i in range(WORLD))

    @pytest.mark.parametrize("what", ["same mesh", "one device and back"])
    def test_round_trips_bitwise(self, ranks, what):
        assert all(res["ckpt"][what] for res in ranks.get())

    def test_one_device_restore_is_the_gathered_state(self, ranks):
        results = ranks.get()
        cfg = tb.BurninConfig(**SMALL)  # the params' layout (gather_state pairs it with opt's)
        shards = [(res["ckpt"]["shards"], res["ckpt"]["shards"]) for res in results]
        want = weights.gather_state(shards, cfg, dict(MESH_3))[0]
        jax.tree_util.tree_map(np.testing.assert_array_equal, results[0]["ckpt"]["whole"], want)

    def test_fall_back_is_agreed_by_every_rank(self, ranks):
        """Rank 3 alone fails to restore step 2; every rank lands on step
        1's state, bitwise."""
        for res in ranks.get():
            assert all(res["ckpt"]["fall-back agreed"])

    def test_a_torn_shard_file_falls_back_and_an_orphan_is_ignored(self, ranks):
        for res in ranks.get():
            assert res["ckpt"]["torn file"]
            assert "lacks ['shard.5-of-8.pt']" in res["ckpt"]["explicit torn step"]

    def test_one_rank_mesh_and_one_device_resume_each_other_bitwise(self, ranks):
        for res in ranks.get():
            full, mesh_then_device, device_then_mesh = res["ckpt"]["one-rank mesh"]
            assert mesh_then_device == full and device_then_mesh == full


class TestElasticResume:
    def test_resume_on_a_shrunk_mesh_keeps_loss_continuity(self, ranks, devices, tmp_path):
        results = [res["elastic"] for res in ranks.get()]
        got = results[0]
        assert all(r["full"] == got["full"] and r["first"] == got["first"] for r in results)
        # Both host blocks resumed the same checkpoint on their own mesh.
        assert all(r["second"] == got["second"] for r in results)
        assert got["mesh4"] == HALF
        final, second = got["second"]
        assert final == 5
        np.testing.assert_allclose(got["first"], got["full"][:3], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(second, got["full"][3:], rtol=2e-3, atol=1e-4)

        small = jb.BurninConfig(**SMALL)
        mesh8 = jlogical(devices, **MESH_3)
        mesh4 = jlogical(devices[:4], **HALF)
        _, full = jc.train_with_resume(small, mesh8, tmp_path / "full", steps=5, save_every=100)
        _, first = jc.train_with_resume(small, mesh8, tmp_path / "elastic", steps=3, save_every=1)
        _, resumed = jc.train_with_resume(small, mesh4, tmp_path / "elastic", steps=2,
                                          save_every=1)
        np.testing.assert_allclose(got["full"], full, rtol=1e-2)
        np.testing.assert_allclose(got["first"] + second, first + resumed, rtol=1e-2)

    def test_incompatible_resize_raises_up_front(self, ranks, devices, tmp_path):
        got = {res["elastic"]["resize"] for res in ranks.get()}
        mesh8 = jlogical(devices, data=8, fsdp=1, model=1)
        jc.train_with_resume(jb.BurninConfig(**SMALL), mesh8, tmp_path / "run", steps=1,
                             save_every=1)
        with pytest.raises(ValueError, match="elastic resume") as want:
            jc.train_with_resume(jb.BurninConfig(**SMALL), jlogical(devices, data=1, fsdp=1,
                                                                    model=8),
                                 tmp_path / "run", steps=1, save_every=1)
        assert got == {str(want.value)}
