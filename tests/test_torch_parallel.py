"""The port's slice burn-in over `torch.distributed` (tpu_dra_torch/api/
topology.py, parallel/mesh.py, collectives.py, gang.py, validate.py)
against the reference's (tpu_dra/api/topology.py, parallel/mesh.py,
collectives.py, gang.py, validate.py) on its 8 virtual CPU devices.

The port runs one process per device, so its side runs in gloo ranks:
8 ranks are spawned once for this module and run every mesh and
collective check as a list (`RANK_CHECKS`), each rank reporting what it
saw; `validate_slice` spawns its own workers.  Reports are compared
whole, ignoring only what a run times (``seconds_p50``, ``busbw_gbps``),
the platform's name and the framework's name in the device-count error.
Every collective check is exact: it moves small integers in f32.

Sharded training in those ranks and workers (the families over their
meshes, validate's training stage) is held to the reference's contract:
the same report keys, ok with a descending loss, the same refusals; its
numbers against the reference's are tests/test_torch_sharded.py's."""

import dataclasses
import json
import multiprocessing
import os
import socket
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_dra import models as jmodels
from tpu_dra.api.topology import Topology as JTopology
from tpu_dra.parallel import burnin as jburnin
from tpu_dra.parallel import collectives as jcoll
from tpu_dra.parallel import gang as jgang
from tpu_dra.parallel import mesh as jmesh
from tpu_dra.parallel import validate as jval
from tpu_dra_torch import models as tmodels
from tpu_dra_torch.api.topology import Topology as TTopology
from tpu_dra_torch.parallel import collectives as tcoll
from tpu_dra_torch.parallel import gang as tgang
from tpu_dra_torch.parallel import mesh as tmesh
from tpu_dra_torch.parallel import validate as tval
from tpu_dra_torch.parallel.kernels.flash_attn import HEAD_DIMS

torch.set_num_threads(1)

WORLD = 8
TOPOLOGIES = ("2x2x2", "4x2x1", "8x1x1")
LOGICAL_BAD = [dict(data=3, model=2), dict(data=-1, fsdp=-1), dict(data=0),
               dict(data=2, fsdp=2, model=3), dict(data=-1, model=3)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _compact(r):
    return {k: v for k, v in vars(r).items() if k not in ("samples", "seconds_p50", "busbw_gbps")}


def _rank_meshes(rank):
    out = {}
    for topo in TOPOLOGIES:
        m = tmesh.slice_mesh(topo)
        out[topo] = (tmesh.mesh_shape(m), m.mesh.tolist())
    m = tmesh.slice_mesh(TTopology(4, 2))
    out["Topology(4, 2)"] = (tmesh.mesh_shape(m), m.mesh.tolist())
    os.environ["TPU_CHIPS_PER_HOST_BOUNDS"] = "2,2,2"
    try:
        m = tmesh.slice_mesh()
        out["env"] = (tmesh.mesh_shape(m), m.mesh.tolist())
    finally:
        del os.environ["TPU_CHIPS_PER_HOST_BOUNDS"]
    m = tmesh.slice_mesh()
    out["default"] = (tmesh.mesh_shape(m), m.mesh.tolist())
    m = tmesh.logical_mesh(data=-1, model=2)
    out["logical"] = (tmesh.mesh_shape(m), m.mesh.tolist())
    out["size_mismatch"] = _error(lambda: tmesh.slice_mesh("2x2x1"))
    out["logical_bad"] = [_error(lambda kw=kw: tmesh.logical_mesh(**kw)) for kw in LOGICAL_BAD]
    return out


def _rank_collectives(rank):
    out = {}
    for topo in TOPOLOGIES:
        m = tmesh.slice_mesh(topo)
        for axis in ("z", "y", "x"):
            for check in (tcoll.psum_check, tcoll.all_gather_check, tcoll.ring_check):
                out[(topo, axis, check.__name__)] = _compact(check(m, axis))
    m = tmesh.slice_mesh("4x2x1")
    for inner, outer in (("x", "y"), ("y", "x"), ("bogus", "y")):
        out[("hier", inner, outer)] = _compact(tcoll.hierarchical_psum_check(m, inner, outer))
    # hierarchical_psum itself on a (dcn, ici) mesh against one flat all-reduce.
    gm = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 4), mesh_dim_names=("dcn", "ici"))
    x = torch.arange(8, dtype=torch.float32) + 10 * rank
    want = x.clone()
    dist.all_reduce(want)
    out["hier_flat"] = torch.equal(tcoll.hierarchical_psum(x, gm, "ici", "dcn"), want)
    m = tmesh.slice_mesh("8x1x1")
    r = tcoll.psum_bandwidth(m, "x", mbytes=1, iters=3, warmup=1)
    out["bandwidth"] = (r.ok, r.error, r.bytes_per_device, r.busbw_gbps > 0, r.seconds_p50 > 0,
                        len(r.samples))
    r = tcoll.psum_bandwidth(m, "y", mbytes=1, iters=1, warmup=1)
    out["bandwidth_trivial"] = (r.ok, r.n_devices, r.busbw_gbps)
    return out


def _rank_gang(rank):
    out = {}
    r = tgang.gang_allreduce(mbytes=1, host=rank // 4)
    out["two_hosts"] = (r.op, r.axis, r.n_devices, r.ok, r.error, r.busbw_gbps > 0)
    r = tgang.gang_allreduce(mbytes=1, host=0)
    out["one_host"] = (r.op, r.axis, r.n_devices, r.ok, r.error)
    r = tgang.hierarchical_allreduce_bandwidth(mbytes=1, hosts=[0] * 5 + [1] * 3)
    out["unequal"] = (r.ok, r.error)
    tgang.barrier()
    out["barrier"] = True
    return out


# train_family over the 8 ranks: (family, what its report must show).
FAMILY_RUNS = {"dense": "ok", "flash": "ok", "rope": "ok", "moe": "ok", "long_context": "ok",
               "long_context_a2a": "ok", "long_context_moe": "ok", "pipelined": "ok"}


def _rank_families(rank):
    out = {}
    for name in FAMILY_RUNS:
        r = tmodels.train_family(name, list(range(WORLD)), steps=2, device="cpu")
        out[name] = (r.ok, r.steps, r.loss_first, r.loss_last, r.error)
    for name in ("dense", "moe", "long_context_a2a", "long_context_moe", "pipelined"):
        out[f"mesh {name}"] = tmesh.mesh_shape(tmodels.family_mesh(name))
    return out


RANK_CHECKS = [("meshes", _rank_meshes), ("collectives", _rank_collectives),
               ("gang", _rank_gang), ("families", _rank_families)]


def _rank_main(rank, init_method, out):
    """One gloo rank of the module's group: every check of `RANK_CHECKS`."""
    torch.set_num_threads(1)
    results = {}
    try:
        tgang.join_group(init_method, world_size=WORLD, rank=rank, device="cpu", timeout_s=120)
        for name, fn in RANK_CHECKS:
            results[name] = fn(rank)
    except Exception as e:  # reported, so the test names the failing rank
        results["error"] = f"{type(e).__name__}: {e}"
    finally:
        out.put((rank, results))
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(r, init, out), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < WORLD:
            rank, res = out.get(timeout=240)
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: res["error"] for r, res in results.items() if "error" in res}
    assert not errors, errors
    return [results[r] for r in range(WORLD)]


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, "conftest must provide 8 virtual CPU devices"
    return devs


def ref_mesh(mesh):
    return dict(mesh.shape), np.vectorize(lambda d: d.id)(mesh.devices).tolist()


class TestTopology:
    @pytest.mark.parametrize("text", ["2x2x1", "4x4", " 2x4x2 ", "1x1x1", "16x16x16"])
    def test_parses_to_the_same_box(self, text):
        j, t = JTopology.parse(text), TTopology.parse(text)
        assert (t.x, t.y, t.z, t.size, t.dims(), str(t)) == (j.x, j.y, j.z, j.size, j.dims(), str(j))
        assert list(t.coords_from((1, 2, 3))) == list(j.coords_from((1, 2, 3)))

    @pytest.mark.parametrize("text", ["", "2x", "x2", "2x2x2x2", "axb", "0x2", "2x0x1", "-1x2"])
    def test_same_error_messages(self, text):
        with pytest.raises(ValueError) as want:
            JTopology.parse(text)
        with pytest.raises(ValueError) as got:
            TTopology.parse(text)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("env", [{}, {"TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1"},
                                     {"TPU_CHIPS_PER_HOST_BOUNDS": ""}])
    def test_topology_from_env(self, env):
        j, t = jmesh.topology_from_env(env), tmesh.topology_from_env(env)
        assert (None if t is None else t.dims()) == (None if j is None else j.dims())

    @pytest.mark.parametrize("bounds", ["2,2", "a,b,c", "1,2,3,4"])
    def test_malformed_env_raises_as_the_reference(self, bounds):
        env = {"TPU_CHIPS_PER_HOST_BOUNDS": bounds}
        assert _error(lambda: tmesh.topology_from_env(env)) == \
            _error(lambda: jmesh.topology_from_env(env))


class TestMesh:
    @pytest.mark.parametrize("topo", TOPOLOGIES)
    def test_slice_mesh_shapes_names_and_rank_order(self, ranks, devices, topo):
        want = ref_mesh(jmesh.slice_mesh(topo, devices))
        assert all(res["meshes"][topo] == want for res in ranks)

    def test_slice_mesh_from_a_topology(self, ranks, devices):
        want = ref_mesh(jmesh.slice_mesh(JTopology(4, 2), devices))
        assert all(res["meshes"]["Topology(4, 2)"] == want for res in ranks)

    def test_slice_mesh_x_minor(self, ranks):
        _, order = ranks[0]["meshes"]["4x2x1"]
        assert order[0][0][0] == 0 and order[0][0][1] == 1 and order[0][1][0] == 4

    def test_slice_mesh_defaults(self, ranks, devices, monkeypatch):
        assert all(res["meshes"]["default"] == ref_mesh(jmesh.slice_mesh(devices=devices))
                   for res in ranks)
        monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", "2,2,2")
        want = ref_mesh(jmesh.slice_mesh(devices=devices))
        assert all(res["meshes"]["env"] == want for res in ranks)

    def test_size_mismatch_message(self, ranks, devices):
        want = _error(lambda: jmesh.slice_mesh("2x2x1", devices))
        assert all(res["meshes"]["size_mismatch"] == want for res in ranks)

    def test_logical_mesh(self, ranks, devices):
        want = ref_mesh(jmesh.logical_mesh(devices, data=-1, model=2))
        assert all(res["meshes"]["logical"] == want for res in ranks)
        want_bad = [_error(lambda kw=kw: jmesh.logical_mesh(devices, **kw)) for kw in LOGICAL_BAD]
        assert all(w is not None for w in want_bad)
        assert all(res["meshes"]["logical_bad"] == want_bad for res in ranks)


class TestCollectives:
    @pytest.mark.parametrize("topo", TOPOLOGIES)
    def test_checks_on_each_axis_equal_the_references(self, ranks, devices, topo):
        mesh = jmesh.slice_mesh(topo, devices)
        for axis in ("z", "y", "x"):
            for check in (jcoll.psum_check, jcoll.all_gather_check, jcoll.ring_check):
                want = _compact(check(mesh, axis))
                assert want["ok"], want
                for res in ranks:
                    assert res["collectives"][(topo, axis, check.__name__)] == want

    def test_hierarchical_psum_check(self, ranks, devices):
        mesh = jmesh.slice_mesh("4x2x1", devices)
        for inner, outer in (("x", "y"), ("y", "x")):
            want = _compact(jcoll.hierarchical_psum_check(mesh, inner, outer))
            assert want["ok"]
            assert all(res["collectives"][("hier", inner, outer)] == want for res in ranks)
        for res in ranks:
            bad = res["collectives"][("hier", "bogus", "y")]
            assert not bad["ok"] and "bogus" in bad["error"]

    def test_hierarchical_psum_equals_the_flat_all_reduce(self, ranks):
        assert all(res["collectives"]["hier_flat"] for res in ranks)

    def test_psum_bandwidth(self, ranks):
        for res in ranks:
            assert res["collectives"]["bandwidth"] == (True, "", 1024 ** 2, True, True, 3)

    def test_psum_bandwidth_trivial_axis(self, ranks, devices):
        want = jcoll.psum_bandwidth(jmesh.slice_mesh("1x1x1", devices[:1]), "x", mbytes=1,
                                    iters=1, warmup=1)
        assert want.busbw_gbps == 0.0
        assert all(res["collectives"]["bandwidth_trivial"] == (True, 1, 0.0) for res in ranks)


class TestGang:
    def test_env_contract_is_the_references(self):
        env = {"TPU_DRA_GANG_COORDINATOR": "10.0.0.1:8476", "TPU_DRA_GANG_SIZE": "64",
               "TPU_DRA_GANG_RANK": "3"}
        j, t = jgang.GangEnv.from_env(env), tgang.GangEnv.from_env(env)
        assert vars(t) == vars(j) and t.as_env() == j.as_env() == env
        assert tgang.GangEnv.from_env({}) is None
        bad = {"TPU_DRA_GANG_COORDINATOR": "h:1", "TPU_DRA_GANG_SIZE": "abc"}
        assert _error(lambda: tgang.GangEnv.from_env(bad)) == \
            _error(lambda: jgang.GangEnv.from_env(bad))

    def test_initialize_gang_is_a_noop_when_solo(self):
        assert tgang.initialize_gang(tgang.GangEnv("h:1", 1, 0), device="cpu") is None
        assert not dist.is_initialized()

    def test_two_host_all_reduce_is_hierarchical(self, ranks):
        for res in ranks:
            op, axis, n, ok, error, positive = res["gang"]["two_hosts"]
            assert (op, axis, n, ok, error, positive) == (
                "hierarchical_allreduce", "ici[4]xdcn[2]", 8, True, "", True)
            assert res["gang"]["one_host"] == ("psum_bandwidth", "data", 8, True, "")
            assert res["gang"]["barrier"]

    def test_unequal_local_counts_are_a_reported_failure(self, ranks):
        for res in ranks:
            assert res["gang"]["unequal"] == (
                False, "unequal local device counts per host: {0: 5, 1: 3}")


def normalized(report: dict) -> dict:
    """A report without what a run times, the platform's name and the
    framework's name in the device-count error."""
    d = {k: v for k, v in report.items() if k not in ("busbw_gbps", "platform")}
    d["checks"] = [{k: v for k, v in c.items() if k not in ("seconds_p50", "busbw_gbps")}
                   for c in d["checks"]]
    d["errors"] = [e.replace(" jax sees ", " torch sees ") for e in d["errors"]]
    return d


# (topology, env): the reference's own acceptance cases and failures.
VALIDATE_CASES = {
    "4x2x1": ("4x2x1", {}),
    "8x1x1": ("8x1x1", {}),
    "env_2x2x2": (None, {"TPU_CHIPS_PER_HOST_BOUNDS": "2,2,2"}),
    "count_mismatch": ("4x2x1", {"TPU_VISIBLE_DEVICES": "0,1,2,3"}),
    "malformed_gang": (None, {"TPU_DRA_GANG_COORDINATOR": "10.0.0.1:8476",
                              "TPU_DRA_GANG_SIZE": "abc"}),
    "gang_size_1": (None, {"TPU_DRA_GANG_COORDINATOR": "10.0.0.1:8476"}),
    "bad_topology": ("2x2x2x2", {}),
    "topology_too_small": ("2x2x1", {}),
    "malformed_bounds": (None, {"TPU_CHIPS_PER_HOST_BOUNDS": "2,2"}),
}


class TestFamilies:
    @pytest.mark.parametrize("name", sorted(FAMILY_RUNS))
    def test_train_family_on_eight_ranks(self, ranks, name):
        """Each family trains sharded over its mesh of the 8 ranks (one
        global loss, descending), the pipelined one over (data 2, pipe 2,
        model 2)."""
        reports = [res["families"][name] for res in ranks]
        assert all(rep == reports[0] for rep in reports)
        ok, steps, first, last, error = reports[0]
        if FAMILY_RUNS[name] == "ok":
            assert ok and steps == 2 and last < first and error == "", reports[0]
        else:
            assert not ok and steps == 0 and FAMILY_RUNS[name] in error, reports[0]

    @pytest.mark.parametrize("name", ["dense", "moe", "long_context_a2a", "long_context_moe",
                                      "pipelined"])
    def test_family_mesh_equals_the_references(self, ranks, devices, name):
        want = dict(jmodels.family_mesh(name, devices).shape)
        assert all(res["families"][f"mesh {name}"] == want for res in ranks)


class TestValidateSlice:
    @pytest.mark.parametrize("name", sorted(VALIDATE_CASES))
    def test_report_equals_the_references(self, name):
        topology, env = VALIDATE_CASES[name]
        want = jval.validate_slice(topology=topology, env=env, bandwidth_mbytes=1)
        got = tval.validate_slice(topology=topology, env=env, bandwidth_mbytes=1, device="cpu",
                                  local_devices=WORLD)
        assert normalized(json.loads(got.to_json())) == normalized(json.loads(want.to_json()))
        if got.n_devices:
            assert got.platform == "cpu"
        if got.ok and got.checks:
            assert got.busbw_gbps > 0

    def test_one_device_trains(self):
        r = tval.validate_slice(env={}, train_steps=2, device="cpu", local_devices=1)
        assert r.ok, r.errors
        assert r.checks == [] and r.topology == "1x1x1" and r.n_devices == 1
        assert r.train["ok"] and r.train["steps"] == 2
        assert r.train["loss_last"] < r.train["loss_first"]

    def test_sharded_training_stage_on_eight_ranks(self):
        """The reference's stage on a mesh with model > 1: the sharded
        step, then ring attention and experts, each ok after 2 steps; the
        report's and each stage's keys are the reference's."""
        r = tval.validate_slice(topology="2x2x2", env={}, train_steps=2, bandwidth_mbytes=1,
                                device="cpu", local_devices=WORLD)
        assert r.ok, r.errors
        got = json.loads(r.to_json())
        assert set(got) == set(json.loads(jval.SliceReport().to_json()))
        want_keys = set(dataclasses.asdict(jburnin.TrainReport(True, 0, 0.0, 0.0, 0.0, 0.0)))
        for key in ("train", "train_ring", "train_moe"):
            tr = got[key]
            assert set(tr) == want_keys, key
            assert tr["ok"] and tr["steps"] == 2 and tr["loss_last"] < tr["loss_first"], (key, tr)

    def test_sharded_training_with_model_1_skips_ring_and_moe(self):
        """Three ranks give burnin_mesh a model axis of 1: the sharded step
        alone, as the reference's stage runs it there."""
        r = tval.validate_slice(topology="3x1x1", env={}, train_steps=2, bandwidth_mbytes=1,
                                device="cpu", local_devices=3)
        assert r.ok, r.errors
        assert r.train["ok"] and r.train["steps"] == 2
        assert r.train_ring is None and r.train_moe is None

    def test_a_gang_of_two_hosts(self):
        init = f"127.0.0.1:{_free_port()}"
        reports = {}

        def host(rank):
            env = {"TPU_DRA_GANG_COORDINATOR": init, "TPU_DRA_GANG_SIZE": "2",
                   "TPU_DRA_GANG_RANK": str(rank)}
            reports[rank] = tval.validate_slice(topology="2x1x1", env=env, bandwidth_mbytes=1,
                                                device="cpu", local_devices=2, timeout_s=120)

        threads = [threading.Thread(target=host, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        for rank, r in reports.items():
            assert r.ok, r.errors
            assert r.gang == {"size": 2, "rank": rank}
            assert [c["op"] for c in r.checks] == [
                "psum", "all_gather", "ppermute_ring", "psum_bandwidth", "hierarchical_allreduce"]
            assert r.checks[-1]["axis"] == "ici[2]xdcn[2]"

    def test_a_missing_gang_member_is_a_report_not_a_hang(self):
        env = {"TPU_DRA_GANG_COORDINATOR": f"127.0.0.1:{_free_port()}",
               "TPU_DRA_GANG_SIZE": "2", "TPU_DRA_GANG_RANK": "0"}
        r = tval.validate_slice(topology="2x1x1", env=env, device="cpu", local_devices=2,
                                timeout_s=5)
        assert not r.ok and r.gang is None
        assert len(r.errors) == 2 and all(e.startswith("gang init failed: worker ")
                                          for e in r.errors)

    def test_no_card_is_a_report_not_a_cpu_run(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the CPU-only refusal cannot show")
        r = tval.validate_slice(env={})
        assert not r.ok and r.n_devices == 0 and r.platform == ""
        assert r.errors[0].startswith("torch initialization failed: ")

    def test_nonfinite_numbers_become_null(self):
        r = tval.SliceReport(busbw_gbps=float("nan"), train={"loss_last": float("inf")})
        assert json.loads(r.to_json())["busbw_gbps"] is None
        assert json.loads(r.to_json())["train"]["loss_last"] is None
        assert r.to_json() == jval.SliceReport(busbw_gbps=float("nan"),
                                               train={"loss_last": float("inf")}).to_json()


ARG_ERRORS = [
    ["--train", "abc"],
    ["--train", "-1"],
    ["--serve"],
    ["--int8"],
    ["--family", "dense", "--int8"],
    ["--family", "nope"],
    ["--family"],
    ["--family", "dense", "2x2x1"],
    ["--family", "dense", "--serve", "--train", "2"],
    ["--family", "dense", "--train", "0"],
]


class TestCli:
    @pytest.mark.parametrize("argv", ARG_ERRORS, ids=lambda a: "_".join(a).strip("-") or "none")
    def test_argument_errors_print_the_references_json(self, argv, capsys):
        want_rc = jval.main(list(argv))
        want = capsys.readouterr().out
        got_rc = tval.main(list(argv), device="cpu")
        got = capsys.readouterr().out
        assert (got_rc, got) == (want_rc, want) and got_rc == 1
        json.loads(got)

    @pytest.mark.parametrize("argv", [["--family", "dense", "--serve"],
                                      ["--family", "flash", "--train", "2"]],
                             ids=["dense_serve", "flash_train"])
    def test_family_probes_on_the_cpu(self, argv, capsys):
        assert tval.main(argv, device="cpu") == 0
        out = json.loads(capsys.readouterr().out)
        assert out["family"] == argv[1] and out["ok"] is True

    @pytest.mark.parametrize("family", ["moe", "long_context_a2a", "long_context_moe"])
    def test_family_trains_over_workers_on_eight_devices(self, capsys, family):
        assert tval.main(["--family", family, "--train", "2"], device="cpu",
                         local_devices=WORLD) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["family"] == family and out["ok"] is True and out["steps"] == 2

    def test_family_probe_without_a_card_fails(self, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the CPU-only refusal cannot show")
        assert tval.main(["--family", "dense", "--serve"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert out["ok"] is False and "no CUDA device" in out["error"]

    def test_suite_without_a_card_fails(self, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the CPU-only refusal cannot show")
        assert tval.main([]) == 1
        out = json.loads(capsys.readouterr().out)
        assert out["ok"] is False and out["errors"][0].startswith("torch initialization failed")

    def test_flash_families_train_at_a_kernel_head_width(self):
        """The flash family's preset (d_model 128 over 8 heads) has d_head
        16: the card's flash kernel must take it, or ``--family flash``
        fails on the card."""
        widths = {}
        for name in tmodels.FAMILIES:
            try:
                cfg = tmodels.family_config(name)
            except ValueError:  # a family the port does not run yet
                continue
            if cfg.flash_attention:
                widths[name] = cfg.d_head
        assert widths and all(d in HEAD_DIMS for d in widths.values()), widths
