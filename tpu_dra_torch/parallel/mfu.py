"""Chip-sized MFU measurement: how much of the card the burn-in LM uses.

Counterpart of `tpu_dra.parallel.mfu` for one device:

- `chip_sized_config`   — the burn-in LM sized by the card's memory class
  (the reference's ladder, unchanged);
- `param_count`, `train_flops_per_step` — exact parameter count and
  analytic model flops per training step (matmul-exact forward x3;
  attention counted at the full s x s, as the reference does, and
  rematerialization's recompute not counted);
- `measure_mfu`         — steady-state step time with the steps enqueued
  back to back and only the last loss fetched, against a peak the caller
  passes in.

The reference's table of TPU peaks (``chip_perf_for``) is not copied:
its numbers are TPU numbers.  Its shrink ladder is not either: a config
that fails here is reported, not measured smaller.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from tpu_dra_torch.parallel.burnin import BurninConfig, make_train_step, sample_tokens
from tpu_dra_torch.parallel.device import resolve_device

__all__ = [
    "MfuReport",
    "chip_sized_config",
    "measure_mfu",
    "param_count",
    "train_flops_per_step",
]


def chip_sized_config(hbm_gib: float) -> BurninConfig:
    """A burn-in LM sized so f32 params + momentum + remat activations +
    the logits buffer fill a healthy share of a card with ``hbm_gib`` of
    device memory (the reference's ladder by memory class)."""
    if hbm_gib >= 90:
        return BurninConfig(
            vocab=32768, d_model=4096, n_heads=32, d_ff=16384,
            n_layers=16, seq=2048, batch=16,
        )
    if hbm_gib >= 30:
        return BurninConfig(
            vocab=32768, d_model=4096, n_heads=32, d_ff=16384,
            n_layers=8, seq=1024, batch=16,
        )
    if hbm_gib >= 14:
        return BurninConfig(
            vocab=32768, d_model=2048, n_heads=16, d_ff=8192,
            n_layers=8, seq=1024, batch=8,
        )
    return BurninConfig(
        vocab=8192, d_model=1024, n_heads=8, d_ff=4096,
        n_layers=4, seq=512, batch=4,
    )


def param_count(c: BurninConfig) -> int:
    """Exact parameter count of the burn-in LM (`init_params` layout)."""
    per_layer = (
        c.d_model * 3 * c.d_model  # wqkv
        + c.d_model * c.d_model    # wo
        + c.d_model * c.d_ff       # w1
        + c.d_ff * c.d_model       # w2
        + 2 * c.d_model            # ln1, ln2
    )
    return (
        c.vocab * c.d_model        # embed (tied with the logits product)
        + c.seq * c.d_model        # pos
        + c.n_layers * per_layer
        + c.d_model                # ln_f
    )


def train_flops_per_step(c: BurninConfig) -> float:
    """Model flops per training step: the forward's matmuls (2 flops per
    multiply-add, attention over the full s x s) x3 for forward and
    backward."""
    b, s, d, f, L, v = c.batch, c.seq, c.d_model, c.d_ff, c.n_layers, c.vocab
    per_layer_fwd = (
        2 * b * s * d * (3 * d)  # qkv projection
        + 2 * b * s * s * d      # q @ k^T
        + 2 * b * s * s * d      # probs @ v
        + 2 * b * s * d * d      # output projection
        + 2 * b * s * d * f      # mlp in
        + 2 * b * s * f * d      # mlp out
    )
    fwd = L * per_layer_fwd + 2 * b * s * d * v  # + the tied logits product
    return 3.0 * fwd


@dataclass
class MfuReport:
    """Steady-state compute utilization of one training step."""

    ok: bool
    platform: str = ""
    device_kind: str = ""
    params: int = 0
    tokens_per_step: int = 0
    flops_per_step: float = 0.0
    step_seconds: float = 0.0
    achieved_tflops: float = 0.0
    peak_tflops: float = 0.0
    mfu: float = 0.0  # 0 when no peak was given
    tokens_per_second: float = 0.0
    loss_first: float = 0.0
    loss_last: float = 0.0
    error: str = ""
    config: "BurninConfig | None" = None


def measure_mfu(config: BurninConfig, *, peak_tflops: float, warmup_steps: int = 2,
                timed_steps: int = 8, device: "str | torch.device" = "cuda") -> MfuReport:
    """Time the training step in steady state and report MFU against
    ``peak_tflops`` (the card's published dense bf16 peak; 0 for none).

    The timed steps are enqueued back to back and only the last one's
    loss is fetched: the steps form a chain through the state, so that
    fetch bounds them all.  Reports, never raises."""
    try:
        dev = resolve_device(device)
        c = config
        step_fn, state = make_train_step(c, dev)
        tokens = sample_tokens(c, device=dev)
        for _ in range(max(1, warmup_steps)):
            state, loss = step_fn(state, tokens)
        loss_first = float(loss)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            state, loss = step_fn(state, tokens)
        loss_last = float(loss)
        elapsed = time.perf_counter() - t0
        step_s = elapsed / timed_steps
        flops = train_flops_per_step(c)
        achieved = flops / step_s / 1e12
        return MfuReport(
            ok=loss_last < loss_first and loss_first == loss_first and loss_last == loss_last,
            platform=dev.type,
            device_kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            params=param_count(c),
            tokens_per_step=c.batch * c.seq,
            flops_per_step=flops,
            step_seconds=step_s,
            achieved_tflops=achieved,
            peak_tflops=peak_tflops,
            mfu=achieved / peak_tflops if peak_tflops > 0 else 0.0,
            tokens_per_second=c.batch * c.seq / step_s,
            loss_first=loss_first,
            loss_last=loss_last,
            config=c,
        )
    except Exception as e:  # a measurement reports, never raises
        return MfuReport(ok=False, error=f"{type(e).__name__}: {e}", config=config)
