"""The yardstick's counts against numbers worked by hand for the
configurations' shapes."""

from __future__ import annotations

import json

import pytest

from benchmark import roofline
from benchmark.tests.conftest import REPO

LM = json.loads((REPO / "benchmark" / "configs" / "burnin-lm-80g.json").read_text())["model"]
MOE = json.loads((REPO / "benchmark" / "configs" / "burnin-moe-80g.json").read_text())["model"]
H100 = roofline.peak_for("NVIDIA H100 80GB HBM3")


def test_parameter_counts():
    assert roofline.param_count(LM) == 1_749_094_400
    # 4 experts of 2 x 4096 x 16384 a layer and a 4096 x 4 router in place of one MLP.
    assert roofline.param_count(MOE) == 1_749_094_400 + 8 * (3 * 2 * 4096 * 16384 + 4096 * 4)


def test_training_flops_full_square_matches_the_reference_count():
    # 3 x (8 x (2bsd 3d + 2bsd d + 2bsd f 2 + 4bssd) + 2bsdV), b 16, s 1024: 178.1 TFLOP.
    full = roofline.train_step_flops(LM, 16, causal_half=False)
    assert full == pytest.approx(178.1e12, rel=5e-4)
    # Causal at half takes half of 3 x 8 x 4bssd = 6.597 TFLOP off.
    assert full - roofline.train_step_flops(LM, 16) == pytest.approx(3.2985e12, rel=1e-4)


def test_flash_forward_bound():
    flops, nbytes = roofline.flash_forward_call(16, 1024, 32, 128)
    assert nbytes == 4 * 16 * 1024 * 32 * 128 * 2
    assert flops == 2 * 16 * 32 * 1024 * 1024 * 128
    # Bound by bytes: 536.9 MB at 3.35 TB/s, 160.26 us.
    assert roofline.bound_s(flops, nbytes, H100) == pytest.approx(160.26e-6, rel=1e-4)


def test_serving_weight_bytes():
    # bf16 layer matrices 8 x (4d^2 + 2df) x 2 B, f32 embedding V d 4 B: 3.758 GB.
    assert roofline.serve_weight_bytes(LM) == 8 * (4 * 4096**2 + 2 * 4096 * 16384) * 2 \
        + 32768 * 4096 * 4
    assert roofline.serve_weight_bytes(MOE) - roofline.serve_weight_bytes(LM) == \
        8 * 3 * 2 * 4096 * 16384 * 2 + 8 * 4096 * 4 * 4


def test_decode_and_k1_counts():
    # Two rows attending 100 and 300 positions: K and V of 400 positions,
    # 8 layers x 2 x 4096 x 2 B each, on top of the weights.
    flops, nbytes = roofline.decode_step(LM, [100, 300])
    assert nbytes == roofline.serve_weight_bytes(LM) + 400 * 8 * 2 * 4096 * 2
    per_token = 8 * (4 * 4096**2 + 2 * 4096 * 16384) + 32768 * 4096
    assert flops == 2 * per_token * 2 + 4 * 4096 * 8 * 400
    k1_flops, k1_bytes = roofline.paged_attention_call(LM, [100, 300])
    assert k1_bytes == 400 * 2 * 4096 * 2 + 2 * 2 * 4096 * 2
    assert k1_flops == 4 * 4096 * 400
    # A decode step at these contexts is bound by its bytes.
    assert roofline.bound_s(flops, nbytes, H100) == nbytes / 3.35e12


def test_prefill_counts_real_tokens():
    flops, nbytes = roofline.prefill(LM, 256)
    per_token = 8 * (4 * 4096**2 + 2 * 4096 * 16384)
    assert flops == 2 * per_token * 256 + 4 * 4096 * 8 * 256 * 257 / 2 + 2 * 32768 * 4096
    assert nbytes == roofline.serve_weight_bytes(LM) + 256 * 8 * 2 * 4096 * 2


def test_peaks_by_name():
    assert H100.bf16_flops == 989e12 and H100.hbm_bytes_per_s == 3.35e12
    assert roofline.peak_for("NVIDIA H100 80GB HBM3") is H100
    assert roofline.peak_for("NVIDIA H100 PCIe") is None
    assert roofline.peak_for("NVIDIA A100-SXM4-80GB") is None
