"""Canonical workload families of the burn-in LM, on one device.

Counterpart of `tpu_dra.models` for the families the port runs:

- ``dense`` — the baseline transformer LM;
- ``flash`` — the same LM with attention through the flash kernel;
- ``rope``  — rotary position embeddings + the flash kernel.

The other families (context-parallel, MoE, pipelined) are named here as
in the reference, but the port's `BurninConfig` rejects their fields
until the multi-device slice: `train_family` reports that rejection as
``TrainReport(ok=False, error=...)``, honoring the reference's "reports,
never raises" contract.  ``serve_family`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_dra_torch.parallel.burnin import BurninConfig, TrainReport, train

__all__ = ["FAMILIES", "family_config", "train_family"]


def _preset(defaults: dict) -> "Callable[..., BurninConfig]":
    def factory(**overrides) -> BurninConfig:
        return dataclasses.replace(BurninConfig(), **{**defaults, **overrides})  # overrides win

    return factory


FAMILIES: "dict[str, Callable[..., BurninConfig]]" = {
    "dense": _preset({}),
    "long_context": _preset({"ring_attention": True}),
    "long_context_a2a": _preset({"ulysses_attention": True, "flash_attention": True}),
    "moe": _preset({"moe_experts": 4}),
    "long_context_moe": _preset({"ring_attention": True, "moe_experts": 4}),
    "flash": _preset({"flash_attention": True}),
    "rope": _preset({"rope": True, "flash_attention": True}),
    "pipelined": _preset({"pipeline_stages": 2, "moe_experts": 2}),
}


def family_config(name: str, **overrides) -> BurninConfig:
    """The named family's canonical config (overrides applied on top).
    An unknown name raises; a family whose fields the port does not run
    yet raises the config's own ValueError."""
    try:
        factory = FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown model family {name!r}; choose from {sorted(FAMILIES)}"
        ) from None
    return factory(**overrides)


def train_family(name: str, *, steps: int = 5, device: "str | torch.device" = "cuda",
                 **overrides) -> TrainReport:
    """Train the named family for ``steps`` steps on one device.

    Reports, never raises, for a known family: a config the port rejects
    comes back as ``TrainReport(ok=False, error=...)`` carrying the
    config's reason."""
    if name not in FAMILIES:
        family_config(name)  # raises: an unknown name is the caller's error
    try:
        config = family_config(name, **overrides)
    except ValueError as e:  # the port's config rejects the family's fields
        return TrainReport(
            ok=False, steps=0, loss_first=0.0, loss_last=0.0,
            step_seconds_p50=0.0, tokens_per_second=0.0,
            error=f"{type(e).__name__}: {e}",
        )
    return train(config, steps=steps, device=device)
