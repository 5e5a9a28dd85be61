"""Chip-sized MFU measurement: how much of the card the burn-in LM uses.

Counterpart of `tpu_dra.parallel.mfu` for one device:

- `chip_sized_config`   — the burn-in LM sized by the card's memory class
  (the reference's ladder, unchanged);
- `param_count`, `train_flops_per_step` — exact parameter count and
  analytic model flops per training step (matmul-exact forward x3;
  attention counted at the full s x s, as the reference does, and
  rematerialization's recompute not counted);
- `CHIP_PERF`, `chip_perf_for` — the card's published peaks, by its name;
- `measure_mfu`         — steady-state step time with the steps enqueued
  back to back and only the last loss fetched, against the card's bf16
  peak (or one the caller passes in);
- `measure_hbm_bandwidth` — a saxpy probe of the device memory's
  streaming rate against the card's peak.

The reference's table holds TPU peaks; this one NVIDIA cards', from
NVIDIA's H100 Tensor Core GPU data sheet (dense rates, no sparsity).
The reference's shrink ladder is not copied: a config that fails here is
reported, not measured smaller.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from tpu_dra_torch.parallel.burnin import BurninConfig, make_train_step, sample_tokens
from tpu_dra_torch.parallel.device import resolve_device

__all__ = [
    "CHIP_PERF",
    "ChipPerf",
    "HbmReport",
    "MfuReport",
    "chip_perf_for",
    "chip_perf_for_name",
    "chip_sized_config",
    "measure_hbm_bandwidth",
    "measure_mfu",
    "param_count",
    "train_flops_per_step",
]


GIB = 1024**3


@dataclass(frozen=True)
class ChipPerf:
    """Published peaks of one card (the reference's fields)."""

    generation: str
    bf16_tflops: float  # dense bf16 tensor-core peak, TFLOP/s
    hbm_gib: float  # device memory, as the data sheet counts it
    hbm_gbps: float  # device memory bandwidth peak, GB/s


# NVIDIA H100 Tensor Core GPU data sheet: bf16 dense (the sheet's
# with-sparsity figure halved), GPU memory, GPU memory bandwidth.
CHIP_PERF = {
    "h100-sxm": ChipPerf("h100-sxm", 989.0, 80, 3350),
    "h100-pcie": ChipPerf("h100-pcie", 756.0, 80, 2000),
    "h100-nvl": ChipPerf("h100-nvl", 835.0, 94, 3900),
}

# Lower-cased substrings of torch.cuda.get_device_name -> table key, the
# more specific first: the SXM part names itself "NVIDIA H100 80GB HBM3".
_NAME_PATTERNS = [
    ("h100 nvl", "h100-nvl"),
    ("h100 pcie", "h100-pcie"),
    ("h100", "h100-sxm"),
]


def chip_perf_for_name(name: str) -> "ChipPerf | None":
    """The table's entry for a card named ``name`` (as
    `torch.cuda.get_device_name` gives it), or None for a card not in it."""
    lowered = name.lower()
    for pattern, key in _NAME_PATTERNS:
        if pattern in lowered:
            return CHIP_PERF[key]
    return None


def chip_perf_for(device: "str | torch.device") -> "ChipPerf | None":
    """The card's published peaks; None off CUDA or for an unknown card
    (no meaningful peak), as the reference gives None off-TPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return chip_perf_for_name(torch.cuda.get_device_name(dev))


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


def measure_mfu(config: BurninConfig, *, peak_tflops: "float | None" = None,
                warmup_steps: int = 2, timed_steps: int = 8,
                device: "str | torch.device" = "cuda") -> MfuReport:
    """Time the training step in steady state and report MFU against
    ``peak_tflops``: by default the card's dense bf16 peak from
    `CHIP_PERF`, 0 (no MFU) off CUDA or on a card not in it.

    The timed steps are enqueued back to back and only the last one's
    loss is fetched: the steps form a chain through the state, so that
    fetch bounds them all.  Reports, never raises."""
    try:
        dev = resolve_device(device)
        if peak_tflops is None:
            perf = chip_perf_for(dev)
            peak_tflops = perf.bf16_tflops if perf is not None else 0.0
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


@dataclass
class HbmReport:
    """Device memory bandwidth probe result."""

    ok: bool
    gbps: float = 0.0
    peak_gbps: float = 0.0
    fraction_of_peak: float = 0.0
    array_mib: float = 0.0
    error: str = ""


def measure_hbm_bandwidth(*, array_bytes: "int | None" = None, iters: int = 10,
                          device: "str | torch.device" = "cuda") -> HbmReport:
    """saxpy probe ``y += 1.000001 * x`` over two f32 arrays of
    ``array_bytes`` (default: an eighth of the card's memory each, 64 MiB
    without a peak): 3 transfers an element (read x, read y, write y),
    purely bandwidth-bound at this size.  One fused in-place kernel
    (``add_`` with ``alpha``): the eager ``a * x + y`` would be two
    kernels and five transfers.  Timed as the reference times it, from a
    value fetch to a value fetch.  Reports, never raises."""
    try:
        dev = resolve_device(device)
        perf = chip_perf_for(dev)
        if array_bytes is None:
            array_bytes = int(perf.hbm_gib * GIB // 8) if perf is not None else 64 << 20
        n = array_bytes // 4  # f32
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        y = torch.zeros((n,), dtype=torch.float32, device=dev)
        y.add_(x, alpha=1.000001)  # warm
        float(y[0])  # a value fetch: a sync that really waits
        t0 = time.perf_counter()
        for _ in range(iters):
            y.add_(x, alpha=1.000001)
        float(y[0])
        elapsed = time.perf_counter() - t0
        gbps = 3 * n * 4 * iters / elapsed / 1e9
        peak = perf.hbm_gbps if perf is not None else 0.0
        return HbmReport(
            ok=True, gbps=gbps, peak_gbps=peak,
            fraction_of_peak=gbps / peak if peak > 0 else 0.0,
            array_mib=n * 4 / (1 << 20),
        )
    except Exception as e:  # a measurement reports, never raises
        return HbmReport(ok=False, error=f"{type(e).__name__}: {e}")
