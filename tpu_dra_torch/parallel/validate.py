"""Slice burn-in: prove a claimed slice works, end to end.

Counterpart of `tpu_dra.parallel.validate`, the program a claiming pod
runs.  It answers, in one JSON report:

1. Does torch see exactly the devices the claim allocated
   (``TPU_VISIBLE_DEVICES`` / ``TPU_CHIPS_PER_HOST_BOUNDS`` from CDI)?
2. Do collectives work along every axis of the claimed topology
   (all-reduce, all-gather, the point-to-point ring)?
3. What all-reduce bus bandwidth does the slice sustain?
4. With ``--train N``, does a training step on the slice learn?

or, with ``--family NAME [--serve [--int8]]``, does one workload
family's training or serving half run.  Exit code 0 iff everything
passed.

The one design change from the reference: JAX drives every local device
from one process, PyTorch one device from one process.  So
`validate_slice` is the per-host launcher: it spawns one worker a local
device, each binds its device and joins a process group of ``gang size x
n_local`` ranks (through a free localhost port when solo, through the
gang's coordinator in a gang), builds the meshes and runs the checks,
and the launcher joins the workers' reports into one.  A worker that
dies or outstays ``timeout_s`` is an error in the report, never a hang.
Training runs in the same workers: on one device alone, and over more
as the reference's stage does, sharded over `burnin.burnin_mesh` of the
host's ranks, then with ring attention and with experts when the mesh's
``model`` axis is larger than 1.  ``--family NAME --train N`` on more
than one local device trains in such workers too, over
`models.family_mesh` of every rank, and ``--family NAME --serve
[--int8]`` serves there (`models.serve_family` over the family's mesh;
the context-parallel and pipelined families report their refusal).

    python -m tpu_dra_torch.parallel.validate [topology] [--train N]
                                              [--family NAME [--serve [--int8]]]
"""

from __future__ import annotations

import json
import multiprocessing
import os
import queue as queue_mod
import socket
import sys
import time
from dataclasses import asdict, dataclass, field

import torch
import torch.distributed as dist

from tpu_dra_torch.api.topology import Topology
from tpu_dra_torch.parallel.burnin import TrainReport
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.gang import GROUP_TIMEOUT_S, GangEnv
from tpu_dra_torch.parallel.mesh import check_topology, topology_from_env

__all__ = ["SliceReport", "main", "validate_slice"]

# A worker's death or error leaves the others waiting in a collective:
# they get this long to report before they are stopped.
_GRACE_S = 10.0


@dataclass
class SliceReport:
    """Everything the burn-in learned about the claimed slice (the
    reference's schema: ``train_ring`` and ``train_moe`` are set when a
    mesh of more than one rank has a ``model`` axis larger than 1)."""

    ok: bool = False
    n_devices: int = 0
    expected_devices: "int | None" = None
    platform: str = ""
    topology: str = ""
    gang: "dict | None" = None
    checks: "list[dict]" = field(default_factory=list)
    busbw_gbps: float = 0.0
    train: "dict | None" = None
    train_ring: "dict | None" = None
    train_moe: "dict | None" = None
    errors: "list[str]" = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(_clean_nonfinite(asdict(self)), sort_keys=True)


def _clean_nonfinite(v):
    """Map NaN/inf floats to None so every report stays parseable JSON (a
    diverged burn-in must still produce a report)."""
    if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
        return None
    if isinstance(v, dict):
        return {k: _clean_nonfinite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_clean_nonfinite(x) for x in v]
    return v


def _expected_device_count(env) -> "int | None":
    visible = env.get("TPU_VISIBLE_DEVICES")
    if visible:
        return len([v for v in visible.split(",") if v != ""])
    return None


def _local_device_count(dev: torch.device, local_devices: "int | None") -> int:
    if dev.type == "cuda":
        return torch.cuda.device_count() if local_devices is None else local_devices
    return 1 if local_devices is None else local_devices


def validate_slice(
    *,
    topology: "Topology | str | None" = None,
    expected_devices: "int | None" = None,
    bandwidth_mbytes: int = 16,
    train_steps: int = 0,
    env: "dict[str, str] | None" = None,
    device: "str | torch.device" = "cuda",
    local_devices: "int | None" = None,
    timeout_s: float = GROUP_TIMEOUT_S,
) -> SliceReport:
    """Run the full burn-in over this host's devices, one worker process
    each.  ``device`` is ``"cuda"`` (the visible cards, or the first
    ``local_devices`` of them) or ``"cpu"`` (``local_devices`` gloo
    ranks, default 1); asking for CUDA without a card is a reported
    error, never a run on the CPU."""
    environ = os.environ if env is None else env
    report = SliceReport()

    try:
        gang = GangEnv.from_env(environ)
    except (ValueError, TypeError) as e:
        report.errors.append(f"malformed gang env: {e}")
        return report
    if gang is not None and gang.size <= 1:
        # A coordinator without a size is a broken injection: a gang
        # member that lost its size env must not pass a local burn-in.
        report.errors.append(
            f"gang coordinator set but gang size is {gang.size} "
            f"(missing/invalid {'TPU_DRA_GANG_SIZE'}?)"
        )
        return report

    try:
        dev = resolve_device(device)
        n_local = _local_device_count(dev, local_devices)
    except Exception as e:
        report.errors.append(f"torch initialization failed: {e}")
        return report
    report.n_devices = n_local
    report.platform = "gpu" if dev.type == "cuda" else "cpu"

    if expected_devices is None:
        expected_devices = _expected_device_count(environ)
    report.expected_devices = expected_devices
    if expected_devices is not None and n_local != expected_devices:
        report.errors.append(
            f"claim allocated {expected_devices} chips but torch sees {n_local}"
        )

    if isinstance(topology, str):
        try:
            topology = Topology.parse(topology)
        except ValueError as e:
            report.errors.append(str(e))
            return report
    if topology is None:
        try:
            topology = topology_from_env(environ)
        except ValueError as e:
            report.errors.append(f"malformed TPU_CHIPS_PER_HOST_BOUNDS: {e}")
            return report
    if topology is None:
        topology = Topology(n_local, 1, 1)
    report.topology = str(topology)
    try:
        check_topology(topology, n_local)
    except ValueError as e:
        report.errors.append(str(e))
        return report

    sizes = {"z": topology.z, "y": topology.y, "x": topology.x}
    axes = [a for a, n in sizes.items() if n > 1]
    world = n_local * (gang.size if gang is not None else 1)
    # Training is skipped once acceptance has failed, as the reference's
    # is: training over a broken link could hang, and the verdict is in.
    train_here = train_steps > 0 and not report.errors
    if axes or gang is not None or train_here:
        plan = {
            "device": dev.type, "n_local": n_local, "topology": topology.dims(), "axes": axes,
            "mbytes": bandwidth_mbytes, "train_steps": train_steps if train_here else 0,
            "train_on_mesh": world > 1,
            "gang": asdict(gang) if gang is not None else None,
            "init_method": f"tcp://127.0.0.1:{_free_port()}", "timeout_s": timeout_s,
        }
        results, failures, joined = _run_workers(plan, timeout_s)
        what = "gang init failed" if gang is not None else "process group init failed"
        unjoined = [r for r in range(n_local) if r not in joined]
        if unjoined:
            for r in unjoined:
                error = results[r]["error"] if r in results else failures[r]
                report.errors.append(f"{what}: worker {r}: {error}")
            return report
        if gang is not None:
            report.gang = {"size": gang.size, "rank": gang.rank}
        report.errors += [f"worker {r}: {e}" for r, e in sorted(failures.items())]
        report.errors += [f"worker {r}: {res['error']}" for r, res in sorted(results.items())
                          if res["error"]]
        _join_checks(report, results)
        if train_here and 0 in results:
            # Every rank reports the same global losses: rank 0's report.
            for key, label in _TRAIN_STAGES:
                tr = results[0].get(key)
                if tr is None:
                    continue
                setattr(report, key, tr)
                if not tr["ok"]:
                    report.errors.append(f"{label}: {tr['error'] or 'loss did not decrease'}")

    report.ok = not report.errors
    return report


# The training stages, each with the reference's label in its error.
_TRAIN_STAGES = (("train", "burnin train"), ("train_ring", "burnin train[ring]"),
                 ("train_moe", "burnin train[moe]"))


def _join_checks(report: SliceReport, results: "dict[int, dict]") -> None:
    """One check list from the lists of the ranks that finished (a rank
    that failed is an error of its own), in the reference's order and
    with its error texts: a check is ok when it is ok on every rank; its
    times are the first rank's."""
    finished = [(r, res["checks"]) for r, res in sorted(results.items()) if not res["error"]]
    if not finished:
        return
    ranks = [r for r, _ in finished]
    best_bw = 0.0
    for entries in zip(*(checks for _, checks in finished)):
        kind, first = entries[0]
        r = dict(first)
        bad = [(rank, e) for rank, (_, e) in zip(ranks, entries) if not e["ok"]]
        r["ok"] = not bad
        if bad:
            r["error"] = "; ".join(f"rank {rank}: {e['error']}" for rank, e in bad if e["error"])
        report.checks.append(r)
        if kind == "axis" and bad:
            report.errors.append(f"{r['op']}[{r['axis']}]: {r['error'] or 'mismatch'}")
        elif kind == "bandwidth":
            if bad:
                report.errors.append(f"psum_bandwidth[{r['axis']}]: {r['error']}")
            else:
                best_bw = r["busbw_gbps"]
        elif kind == "hierarchical" and bad:
            report.errors.append(f"hierarchical_psum[{r['axis']}]: {r['error']}")
        elif kind == "gang" and bad:
            report.errors.append(f"gang_allreduce: {r['error']}")
    report.busbw_gbps = best_bw


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(plan: dict, timeout_s: float):
    """Spawn one worker a local device and gather their results:
    ``(results by local rank, failures by local rank, the local ranks
    that joined the group)``.  A worker that exits without a result, or
    is still out when the time is up, is a failure; once one fails or
    reports an error, the others get ``_GRACE_S`` to finish before every
    worker left is stopped."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, plan, out), daemon=True)
             for r in range(plan["n_local"])]
    for p in procs:
        p.start()
    results: "dict[int, dict]" = {}
    joined, stopped = set(), set()
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:
                rank, kind, res = out.get(timeout=0.2)
            except queue_mod.Empty:
                # A result is in the pipe before its worker's exit code
                # is set, so a dead worker with none has none to come.
                if any(p.exitcode is not None and r not in results
                       for r, p in enumerate(procs)):
                    deadline = min(deadline, time.monotonic() + _GRACE_S)
                continue
            if kind == "joined":
                joined.add(rank)
                continue
            results[rank] = res
            # A rank whose training failed may leave the others waiting in
            # a collective of the step.
            failed_train = any(res.get(key) is not None and not res[key]["ok"]
                               for key in [k for k, _ in _TRAIN_STAGES] + ["serve"])
            if res["error"] or failed_train:
                deadline = min(deadline, time.monotonic() + _GRACE_S)
    finally:
        for r, p in enumerate(procs):
            p.join(timeout=5.0 if r in results else 0.1)
            if p.is_alive():
                stopped.add(r)
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    failures = {
        r: (f"no report within {timeout_s:g} s (or {_GRACE_S:g} s after another worker "
            "failed); stopped" if r in stopped else
            f"exited with code {p.exitcode} before reporting")
        for r, p in enumerate(procs) if r not in results
    }
    return results, failures, joined


def _worker(local_rank: int, plan: dict, out) -> None:
    """One rank: bind the device, join the group (and say so on ``out``),
    run the checks and the training stage, or a family's training, and
    put its result on ``out``."""
    result = {"checks": [], "train": None, "train_ring": None, "train_moe": None, "serve": None,
              "error": ""}
    try:
        _run_rank(local_rank, plan, result, lambda: out.put((local_rank, "joined", None)))
    except Exception as e:  # reported to the launcher, which reports it
        result["error"] = f"{type(e).__name__}: {e}"
    out.put((local_rank, "result", result))
    if dist.is_initialized():
        dist.destroy_process_group()


def _compact(r) -> dict:
    d = asdict(r)
    d.pop("samples", None)
    return d


def _run_rank(local_rank: int, plan: dict, result: dict, on_joined) -> None:
    from tpu_dra_torch.parallel import burnin
    from tpu_dra_torch.parallel.collectives import (
        all_gather_check,
        hierarchical_psum_check,
        psum_bandwidth,
        psum_check,
        ring_check,
    )
    from tpu_dra_torch.parallel.gang import gang_allreduce, initialize_gang, join_group
    from tpu_dra_torch.parallel.mesh import slice_mesh

    n_local, axes = plan["n_local"], plan["axes"]
    if plan["device"] == "cuda":
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)  # n_local ranks share the host's cores
    gang = GangEnv(**plan["gang"]) if plan["gang"] is not None else None
    if gang is not None:
        initialize_gang(gang, local_rank=local_rank, n_local=n_local, device=dev,
                        timeout_s=plan["timeout_s"])
    elif n_local > 1:
        join_group(plan["init_method"], world_size=n_local, rank=local_rank, device=dev,
                   timeout_s=plan["timeout_s"])
    on_joined()
    if plan.get("family"):
        from tpu_dra_torch.models import serve_family, train_family

        # Over every rank of the group, as the reference trains (and
        # serves) a family over every device it sees.
        ranks = list(range(dist.get_world_size()) if dist.is_initialized() else [0])
        if plan.get("serve"):
            result["serve"] = asdict(serve_family(plan["family"], ranks, int8=plan["int8"],
                                                  device=dev))
        else:
            result["train"] = asdict(train_family(plan["family"], ranks,
                                                  steps=plan["train_steps"], device=dev))
        return
    checks = result["checks"]
    host = gang.rank if gang is not None else 0
    if axes or gang is not None:
        topology = Topology(*plan["topology"])
        mesh = slice_mesh(topology, range(host * n_local, (host + 1) * n_local))
        sizes = {"z": topology.z, "y": topology.y, "x": topology.x}
        for axis in axes:
            for check in (psum_check, all_gather_check, ring_check):
                checks.append(("axis", _compact(check(mesh, axis))))
        if axes:  # the headline number: the largest axis
            axis = max(axes, key=lambda a: sizes[a])
            checks.append(("bandwidth", _compact(psum_bandwidth(mesh, axis, mbytes=plan["mbytes"]))))
        if len(axes) >= 2:  # two-level: reduce-scatter inside, all-reduce across
            inner, outer = sorted(axes, key=lambda a: sizes[a], reverse=True)[:2]
            checks.append(("hierarchical", _compact(hierarchical_psum_check(mesh, inner, outer))))
        if gang is not None:
            checks.append(("gang", _compact(gang_allreduce(mbytes=plan["mbytes"], host=host))))
    if plan["train_steps"] > 0 and plan.get("train_on_mesh"):
        _train_on_mesh(plan["train_steps"], result, mesh,
                       range(host * n_local, (host + 1) * n_local))
    elif plan["train_steps"] > 0:
        result["train"] = asdict(burnin.train(steps=plan["train_steps"], device=dev))


def _train_on_mesh(steps: int, result: dict, mesh, ranks) -> None:
    """The reference's training stage over the host's ``ranks`` (its
    local devices): the burn-in step sharded over `burnin.burnin_mesh`,
    then, when it learned and the mesh's ``model`` axis is larger than 1,
    the same with ring attention and with 4 experts.  Skipped when a
    check failed on any of the host's ranks (``mesh``, the slice mesh,
    carries that vote)."""
    from tpu_dra_torch.parallel import burnin
    from tpu_dra_torch.parallel.collectives import rank_device
    from tpu_dra_torch.parallel.mesh import mesh_shape

    vote = torch.tensor([int(all(e["ok"] for _, e in result["checks"]))],
                        device=rank_device(mesh))
    for axis, n in mesh_shape(mesh).items():
        if n > 1:
            dist.all_reduce(vote, op=dist.ReduceOp.MIN, group=mesh.get_group(axis))
    if not int(vote.item()):
        return
    bmesh = burnin.burnin_mesh(ranks)
    tr = burnin.train(mesh=bmesh, steps=steps)
    result["train"] = asdict(tr)
    if tr.ok and mesh_shape(bmesh)["model"] > 1:
        # Long-context acceptance (the K/V ring on the links), then
        # expert parallelism (the dispatch on the same links).
        result["train_ring"] = asdict(
            burnin.train(burnin.BurninConfig(ring_attention=True), bmesh, steps))
        result["train_moe"] = asdict(
            burnin.train(burnin.BurninConfig(moe_experts=4), bmesh, steps))


def _family_on_workers(family: str, steps: int, device, n_local: int,
                       serve: bool = False, int8: bool = False):
    """``--family NAME --train N`` (or ``--serve [--int8]``) on ``n_local``
    local devices: one worker a device (in the gang's group, when there
    is one), the family trained (or served) over `models.family_mesh` of
    every rank.  Returns ``(rank 0's TrainReport or ServeReport, the
    GangEnv or None)``; a worker that fails or outstays the time is a
    failed report."""
    from tpu_dra_torch.models import ServeReport

    gang = GangEnv.from_env(os.environ)
    if gang is not None and gang.size <= 1:
        gang = None
    plan = {
        "device": resolve_device(device).type, "n_local": n_local, "topology": (n_local, 1, 1),
        "axes": [], "mbytes": 0, "train_steps": steps, "family": family,
        "serve": serve, "int8": int8,
        "gang": asdict(gang) if gang is not None else None,
        "init_method": f"tcp://127.0.0.1:{_free_port()}", "timeout_s": GROUP_TIMEOUT_S,
    }
    results, failures, _ = _run_workers(plan, GROUP_TIMEOUT_S)
    key = "serve" if serve else "train"
    if 0 in results and results[0][key] is not None:
        return (ServeReport if serve else TrainReport)(**results[0][key]), gang
    errors = [f"worker {r}: {e}" for r, e in sorted(failures.items())]
    errors += [f"worker {r}: {res['error']}" for r, res in sorted(results.items()) if res["error"]]
    if serve:
        return ServeReport(ok=False, error="; ".join(errors)), gang
    return TrainReport(ok=False, steps=0, loss_first=0.0, loss_last=0.0, step_seconds_p50=0.0,
                       tokens_per_second=0.0, error="; ".join(errors)), gang


def main(argv: "list[str] | None" = None, *, device: "str | torch.device" = "cuda",
         local_devices: "int | None" = None) -> int:
    """CLI: ``python -m tpu_dra_torch.parallel.validate [topology]
    [--train N] [--family NAME [--serve [--int8]]]``, the reference's
    flags, argument errors and JSON on every outcome.

    ``--family`` runs one workload family (`tpu_dra_torch.models`)
    instead of the acceptance suite: on one device in this process, or
    on more in one worker a device, sharded over the family's mesh;
    ``--serve`` probes its serving half instead of training it, the same
    way (``--int8``: the full int8 stack).  ``device`` and
    ``local_devices`` are `validate_slice`'s (the command line runs on
    the cards)."""
    argv = sys.argv[1:] if argv is None else argv
    train_steps = 0
    train_given = False
    family = None
    serve = False
    if "--serve" in argv:
        argv = [a for a in argv if a != "--serve"]
        serve = True
    int8 = False
    if "--int8" in argv:
        argv = [a for a in argv if a != "--int8"]
        int8 = True
    if "--family" in argv:
        i = argv.index("--family")
        family = argv[i + 1] if i + 1 < len(argv) else ""
        argv = argv[:i] + argv[i + 2:]

    def arg_error(message: str) -> int:
        # The error's shape follows the mode, so every outcome parses by one schema.
        if family is not None:
            print(json.dumps({"family": family, "ok": False, "error": message}, sort_keys=True))
        else:
            print(SliceReport(errors=[message]).to_json())
        return 1

    if "--train" in argv:
        i = argv.index("--train")
        raw = argv[i + 1] if i + 1 < len(argv) else "5"
        try:
            train_steps = int(raw)
        except ValueError:
            return arg_error(f"--train expects an integer, got {raw!r}")
        if train_steps < 0:
            return arg_error(f"--train must be >= 0, got {train_steps}")
        train_given = True
        argv = argv[:i] + argv[i + 2:]
    if serve and family is None:
        return arg_error("--serve requires --family NAME")
    if int8 and not serve:
        return arg_error("--int8 requires --serve (it configures the serving probe)")
    if family is not None:
        from tpu_dra_torch.models import FAMILIES, serve_family, train_family
        from tpu_dra_torch.parallel.gang import initialize_gang

        if argv:
            # The probe runs on the visible device; a topology argument
            # would be silently ignored, so it is refused.
            return arg_error(
                "--family probes the visible slice; a topology argument "
                f"({argv[0]!r}) is not supported with it"
            )
        if family not in FAMILIES:
            return arg_error(f"unknown family; choose from {sorted(FAMILIES)}")
        if serve and train_given:
            return arg_error(
                "--serve and --train are mutually exclusive (one probe, "
                "one half of the workload)"
            )
        if not serve and train_given and train_steps == 0:
            return arg_error(
                "--family with --train requires --train >= 1 (a training "
                "probe always trains; to probe the serving half instead, "
                "use --family NAME --serve)"
            )
        steps = train_steps if train_given else 5
        n_local = 1
        try:
            n_local = _local_device_count(resolve_device(device), local_devices)
        except RuntimeError:  # no card: the one-device probe reports it
            pass
        if n_local > 1:
            try:
                r, gang = _family_on_workers(family, steps, device, n_local, serve, int8)
            except (ValueError, TypeError) as e:
                return arg_error(f"malformed gang env: {e}")
        else:
            try:
                gang = initialize_gang(device=device)
            except Exception as e:
                return arg_error(f"gang initialization failed: {type(e).__name__}: {e}")
            if serve:
                r = serve_family(family, int8=int8, device=device)
            else:
                r = train_family(family, steps=steps, device=device)
        extra = asdict(r)
        if gang is not None:
            extra["gang"] = {"rank": gang.rank, "size": gang.size}
        print(json.dumps(_clean_nonfinite({"family": family, **extra}), sort_keys=True))
        return 0 if r.ok else 1
    topology = argv[0] if argv else None
    report = validate_slice(topology=topology, train_steps=train_steps, device=device,
                            local_devices=local_devices)
    print(report.to_json())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
