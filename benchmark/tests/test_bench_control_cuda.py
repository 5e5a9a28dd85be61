"""The controls at each cell's own size, on the card: the program's int8
weights and KV for a serving cell, the reference with fp8 products for
the training cell.  Each must come out not correct on three seeds.  The
benchmark's own runs never run these (`benchmark/control.py` prints the
readings PERF.md gives)."""

from __future__ import annotations

import time

import pytest

from benchmark.tests.conftest import REPO

CONTROLS = [("dense-chat", "int8"), ("moe-batch", "int8"), ("dense-train", "fp8")]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", CONTROLS)
def test_control_is_not_correct(card, cell, variant):
    from benchmark import harness

    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        line, _ = harness.run_cell(cell, seed, 10.0, False, root=REPO, devices=[card],
                                   t_process=time.perf_counter(), variant=variant)
        assert not line["correct"], (seed, line["checks"])
