"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
cells added as files, the way a later change adds a cell.  Run them with
`python -m pytest benchmark/tests -q` from the repository's root; the
repository's own `pytest tests/` does not collect them."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"vocab": 512, "d_model": 64, "n_heads": 4, "d_ff": 128, "n_layers": 2, "seq": 128}
LENGTHS = {"prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 4, "max": 64},
           "output": {"dist": "uniform", "min": 4, "max": 32}, "base_seed": 1}
# Limits of the tiny cells, set from their own CPU readings: the sound run
# reads a third of each or less, every planted fault three times one or more.
TINY_CELLS = {
    "tiny-chat": ({"config": "tiny-lm", "traffic": "tiny-chat", "chips": 1, "driver": "serve",
                   "engine": {"slots": 8, "prompt_slots": 64, "max_new_cap": 32,
                              "prefix_window": 16, "attn_backend": "cuda", "kv_layout": "paged"},
                   "limits": {"served_gap_mean": 1e-3}},
                  {"arrivals": {"kind": "poisson", "rate_per_s": 20.0}, **LENGTHS}),
    "tiny-batch": ({"config": "tiny-moe", "traffic": "tiny-batch", "chips": 1, "driver": "serve",
                    "engine": {"slots": 4, "prompt_slots": 64, "max_new_cap": 32,
                               "kv_layout": "rows"},
                    "limits": {"served_gap_mean": 0.05}},
                   {"arrivals": {"kind": "backlog", "depth": 8}, **LENGTHS}),
    "tiny-train": ({"config": "tiny-lm", "traffic": "tiny-train", "chips": 1, "driver": "train",
                    "trainer": {"learning_rate": 0.01, "optimizer": "momentum",
                                "flash_attention": True},
                    "limits": {"loss_gap": 1e-3, "grad_norm_gap": 0.05, "update_norm_gap": 0.05}},
                   {"arrivals": {"kind": "steps", "batch": 4}}),
}
# Which real cell each tiny one stands in for (the metrics it reports).
STANDS_FOR = {"tiny-chat": "dense-chat", "tiny-batch": "moe-batch", "tiny-train": "dense-train"}


def add_cell(root: Path, name: str, cell: dict, traffic: dict, stands_for: str) -> None:
    """Add a cell to the benchmark under ``root`` as files and entries only."""
    b = root / "benchmark"
    (b / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    (b / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": cell["config"], "traffic": cell["traffic"],
                               "chips": cell["chips"], "why": "a tiny cell of the CPU tests"})
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if stands_for in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark with the tiny configurations and cells."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, moe in (("tiny-lm", 0), ("tiny-moe", 4)):
        (root / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(
            {"model": {**TINY, "moe_experts": moe, "moe_capacity": 1.25}}))
    for name, (cell, traffic) in TINY_CELLS.items():
        add_cell(root, name, cell, traffic, STANDS_FOR[name])
    return root


def run_tiny(root: Path, name: str, *, seed: int = 2**31 + 11, seconds: float = 2.0,
             trace: bool = False, fault: str = "", variant: str = ""):
    """One run of a tiny cell on the CPU: the harness without the look for
    a card."""
    import time

    import torch

    from benchmark import harness

    torch.manual_seed(0)
    return harness.run_cell(name, seed, seconds, trace, root=root,
                            devices=[torch.device("cpu")], t_process=time.perf_counter(),
                            fault=fault, variant=variant)
