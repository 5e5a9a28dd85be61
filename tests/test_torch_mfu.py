"""The port's card peaks and memory probe (tpu_dra_torch/parallel/mfu.py:
`CHIP_PERF`, `chip_perf_for`, `measure_hbm_bandwidth`, `measure_mfu`'s
default peak) against the reference's contract (tpu_dra/parallel/mfu.py:
None and peak 0 off the accelerator, the saxpy probe's bytes).

The table's numbers are NVIDIA's H100 data sheet's and are checked as
written there; nothing here is timed as a device number."""

import dataclasses

import pytest
import torch

from tpu_dra.parallel import mfu as jmfu
from tpu_dra_torch.parallel import burnin as tb
from tpu_dra_torch.parallel import mfu as tmfu

torch.set_num_threads(2)


class TestTable:
    @pytest.mark.parametrize("name, key", [
        ("NVIDIA H100 80GB HBM3", "h100-sxm"),
        ("NVIDIA H100 SXM5 80GB", "h100-sxm"),
        ("NVIDIA H100 PCIe", "h100-pcie"),
        ("NVIDIA H100 NVL", "h100-nvl"),
        ("nvidia h100 nvl", "h100-nvl"),
    ])
    def test_names_find_their_entry(self, name, key):
        assert tmfu.chip_perf_for_name(name) is tmfu.CHIP_PERF[key]

    @pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA GeForce RTX 4090", "", "cpu"])
    def test_unknown_cards_have_no_entry(self, name):
        assert tmfu.chip_perf_for_name(name) is None

    def test_data_sheet_numbers(self):
        sxm, pcie, nvl = (tmfu.CHIP_PERF[k] for k in ("h100-sxm", "h100-pcie", "h100-nvl"))
        assert (sxm.bf16_tflops, sxm.hbm_gib, sxm.hbm_gbps) == (989.0, 80, 3350)
        assert (pcie.bf16_tflops, pcie.hbm_gib, pcie.hbm_gbps) == (756.0, 80, 2000)
        assert (nvl.bf16_tflops, nvl.hbm_gib, nvl.hbm_gbps) == (835.0, 94, 3900)
        assert all(not k.startswith("v") for k in tmfu.CHIP_PERF)  # no TPU entries

    def test_fields_are_the_references(self):
        assert [f.name for f in dataclasses.fields(tmfu.ChipPerf)] == \
            [f.name for f in dataclasses.fields(jmfu.ChipPerf)]
        assert [f.name for f in dataclasses.fields(tmfu.HbmReport)] == \
            [f.name for f in dataclasses.fields(jmfu.HbmReport)]

    def test_none_off_cuda(self):
        assert tmfu.chip_perf_for("cpu") is None
        assert tmfu.chip_perf_for(torch.device("cpu")) is None


class TestHbmProbe:
    def test_cpu_rung_reports_ok_with_no_peak(self):
        want = jmfu.measure_hbm_bandwidth(array_bytes=8 << 20, iters=2)
        got = tmfu.measure_hbm_bandwidth(array_bytes=8 << 20, iters=2, device="cpu")
        assert want.ok and got.ok, (want, got)
        assert got.gbps > 0 and got.peak_gbps == want.peak_gbps == 0
        assert got.fraction_of_peak == want.fraction_of_peak == 0
        assert got.array_mib == want.array_mib == 8.0

    def test_default_size_without_a_peak_is_64_mib(self):
        got = tmfu.measure_hbm_bandwidth(iters=1, device="cpu")
        assert got.ok and got.array_mib == 64.0

    def test_one_fused_in_place_pass_per_iteration(self, monkeypatch):
        """The probe's arithmetic is the reference's ``1.000001 * x + y``,
        in one in-place pass a step: after n steps y == n * 1.000001."""
        calls = []
        real = torch.Tensor.add_

        def counting(self, other, *, alpha=1):
            calls.append(alpha)
            return real(self, other, alpha=alpha)

        monkeypatch.setattr(torch.Tensor, "add_", counting)
        r = tmfu.measure_hbm_bandwidth(array_bytes=1 << 20, iters=3, device="cpu")
        assert r.ok and calls == [1.000001] * 4  # a warm-up pass, then the timed ones

    def test_no_card_is_a_report(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the CPU-only refusal cannot show")
        r = tmfu.measure_hbm_bandwidth()
        assert not r.ok and "no CUDA device" in r.error


class TestMfuPeak:
    def test_default_peak_is_zero_off_cuda(self):
        c = tb.BurninConfig(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=1, seq=32, batch=4)
        r = tmfu.measure_mfu(c, warmup_steps=1, timed_steps=2, device="cpu")
        assert r.ok, r.error
        assert r.peak_tflops == 0 and r.mfu == 0 and r.achieved_tflops > 0
