"""Each driver's control flow at a tiny size on the CPU, and `correct`
coming out false with the timed path broken underneath: a token altered
where it is produced (serving), half of the batch left out with the mean
over the rest, and a step that returns its state unchanged (training).
The exchange between cards has no cell here: every cell runs on one."""

from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO, run_tiny


@pytest.mark.parametrize("cell", ["tiny-chat", "tiny-batch", "tiny-train"])
def test_sound_run_is_correct(tiny_root, cell):
    line, checks = run_tiny(tiny_root, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c.value <= c.limit / 3 for c in checks), line["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-chat", "token"), ("tiny-batch", "token"),
    ("tiny-train", "half_batch"), ("tiny-train", "no_update"),
])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    line, checks = run_tiny(tiny_root, cell, fault=fault)
    assert not line["correct"]
    assert any(c.value >= 3 * c.limit for c in checks), line["checks"]


def test_serving_counts_requests_of_the_window(tiny_root):
    line, _ = run_tiny(tiny_root, "tiny-chat", seconds=3.0)
    # An open loop at 20/s offers 60 requests in 3 s, each due in the window.
    assert line["attempted"] == 60


def test_run_without_a_card_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dense-chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_run_in_a_bare_checkout_fails(tmp_path):
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dense-chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
