"""The port's workload families' serving acceptance
(tpu_dra_torch/models: `serve_family`) against the reference's
(tpu_dra/models: `serve_family` on one device): each family's report
has the reference's verdict — the single-device families (dense, flash,
rope, moe; moe and dense also on the full int8 stack) serve healthy
generations of the expected shape, and the context-parallel and
pipelined families come back refused with their reason, never raised
(the pipelined one on one device with the reference's words)."""

import jax
import pytest
import torch

from tpu_dra import models as jmodels
from tpu_dra_torch import models

torch.set_num_threads(2)

CASES = [(name, False) for name in sorted(models.FAMILIES)] + [("dense", True), ("moe", True)]


@pytest.mark.parametrize("name,int8", CASES, ids=[f"{n}-{'int8' if q else 'bf16'}"
                                                  for n, q in CASES])
def test_report_matches_reference(name, int8):
    want = jmodels.serve_family(name, [jax.devices()[0]], steps=4, prompt_len=8, int8=int8)
    got = models.serve_family(name, steps=4, prompt_len=8, int8=int8, device="cpu")
    assert got.ok == want.ok, (got, want)
    if got.ok:
        assert got.error == "" and (got.batch, got.steps) == (want.batch, want.steps) == (8, 4)
        assert got.tokens_per_second > 0 and got.request_ms > 0
    else:
        assert got.error.startswith("ValueError: ") and want.error, (got, want)
        assert (got.batch, got.steps) == (0, 0)
        if name == "pipelined":
            # One device: the reference's pipeline_mesh refusal, word for word.
            assert got.error == want.error == (
                "ValueError: 1 devices not divisible into 2 stages x 1 model")


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown model family"):
        models.serve_family("nope", device="cpu")


def test_unhealthy_generation_is_reported():
    """A generation with non-finite logits comes back ok=False with the
    reference's reason."""
    real = models.init_params

    def poisoned(c, *args, **kw):
        params = real(c, *args, **kw)
        params["ln_f"].fill_(float("nan"))
        return params

    try:
        models.init_params = poisoned
        report = models.serve_family("dense", steps=2, device="cpu", vocab=64, d_model=32,
                                     n_heads=4, d_ff=64, seq=32, batch=2)
    finally:
        models.init_params = real
    assert not report.ok and report.error == (
        "health check failed: non-finite logits during generation")
