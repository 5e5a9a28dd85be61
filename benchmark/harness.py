"""Runs one cell once and assembles its result line.

Everything a cell needs is found by name: the workload's entry in
``BENCHMARK.json`` names its configuration and traffic, which live in
``configs/<config>.json`` and ``traffic/<traffic>.json``; the cell's own
settings (driver, engine or trainer, the limits of its correctness
checks) in ``workloads/<name>.json``; the driver in
``drivers/<kind>.py``; each per-layer metric's reader in
``metrics/<metric>.py``.  Adding a cell, a configuration or a metric adds
files and entries; no file here changes.

`run_cell` is the whole run without the look for a card, so the tests
drive it on the CPU at a tiny size; `run.py` looks for the cards first.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark import roofline

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_dra")


@dataclass
class Check:
    """One number compared with the reference, beside its limit (the
    number passes at or below the limit)."""

    name: str
    value: float
    limit: "float | None"

    @property
    def ok(self) -> bool:
        return self.limit is not None and math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back."""

    attempted: int
    failed: int
    e2e: "dict[str, float]"
    checks: "list[Check]"
    memory_peak_bytes: int
    layer: dict = field(default_factory=dict)  # what the per-layer readers read
    trace: object = None  # devtrace.DeviceTrace of the profiled sub-window
    readings: dict = field(default_factory=dict)  # more readings of the check, for stderr


@dataclass
class Run:
    """One run of one cell, as the driver sees it."""

    name: str
    bench: dict  # the workload's entry in BENCHMARK.json
    cell: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    seed: int
    seconds: float
    trace: bool
    devices: "list[torch.device]"
    t_process: float
    variant: str = ""  # "" as configured; a control's lower precision
    fault: str = ""  # a planted fault (tests and controls only)
    setup_s: "float | None" = None
    marks: dict = field(default_factory=dict)  # set-up's stages, seconds from process start

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def limit(self, check: str) -> "float | None":
        return self.cell.get("limits", {}).get(check)

    def mark(self, stage: str) -> None:
        """Note that set-up's ``stage`` has ended (printed with the readings)."""
        sync(self.devices)
        self.marks[stage] = time.perf_counter() - self.t_process

    def setup_done(self) -> None:
        """Mark the end of set-up: the next operation is timed."""
        self.mark("setup")
        self.setup_s = self.marks["setup"]


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"known: {[w['name'] for w in bench['workloads']]}")


def metrics_for(bench: dict, kind: str, workload: dict) -> "list[dict]":
    """The ``end_to_end`` or ``per_layer`` metrics this workload reports."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or workload["name"] in m["workloads"]]
    e2e = {m["name"] for m in metrics_for(bench, "end_to_end", workload)}
    return [m for m in bench["per_layer"]
            if workload["name"] in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def load_cell(root: Path, name: str):
    """The workload entry, cell, configuration and traffic of ``name``."""
    bench = load_json(root / "BENCHMARK.json")
    w = find_workload(bench, name)
    here = root / "benchmark"
    cell = load_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if key in cell and cell[key] != w[key]:
            raise ValueError(f"workloads/{name}.json says {key}={cell[key]!r}, "
                             f"BENCHMARK.json says {w[key]!r}")
    config = load_json(here / "configs" / f"{w['config']}.json")
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    return bench, w, cell, config, traffic


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, root: Path,
             devices: "list[torch.device]", t_process: float, variant: str = "",
             fault: str = "") -> "tuple[dict, list[Check]]":
    """One run of cell ``name``: its result line (a dict) and the checks."""
    bench, w, cell, config, traffic = load_cell(root, name)
    run = Run(name=name, bench=w, cell=cell, config=config, traffic=traffic, seed=seed,
              seconds=seconds, trace=trace, devices=devices, t_process=t_process,
              variant=variant, fault=fault)
    for d in devices:
        if d.type == "cuda":
            torch.empty(0, device=d)  # the context, before its statistics
            torch.cuda.reset_peak_memory_stats(d)
    run.mark("context")
    here = root / "benchmark"
    driver = load_module(here / "drivers" / f"{cell['driver']}.py", f"bench_driver_{cell['driver']}")
    out: Outcome = driver.run(run)
    metrics: "dict[str, dict]" = {}
    if trace:
        ctx = Context(run=run, outcome=out)
        for m in metrics_for(bench, "per_layer", w):
            reader = load_module(here / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_for(bench, "end_to_end", w):
            # A metric named "<quantity>.<tag>" (a quantity bounded apart
            # in some cells) reports the driver's <quantity>.
            value = run.setup_s if m["name"] == "setup_s" else \
                out.e2e.get(m["name"], out.e2e.get(m["name"].split(".", 1)[0]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu"
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": kind,
              "count": len(devices), "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
            "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace.mean_busy_s()
        device["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_device_ops(),
                             "idle_gaps": out.trace.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    print("readings " + json.dumps({**out.readings, "setup_marks_s": run.marks}), file=sys.stderr)
    return line, out.checks


@dataclass
class Context:
    """What a per-layer reader reads: the run and the driver's outcome."""

    run: Run
    outcome: Outcome

    @property
    def model(self) -> dict:
        return self.run.model

    @property
    def layer(self) -> dict:
        return self.outcome.layer

    @property
    def trace(self):
        return self.outcome.trace

    @property
    def peak(self) -> "roofline.Peak | None":
        if self.run.device.type != "cuda":
            return None
        return roofline.peak_for(torch.cuda.get_device_name(self.run.device))


def forbidden_modules() -> "list[str]":
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN})
