"""Canonical workload families of the burn-in LM.

Counterpart of `tpu_dra.models` for the families the port runs:

- ``dense``            — the baseline transformer LM;
- ``long_context``     — the same LM with ring attention (cp; a mesh only);
- ``long_context_a2a`` — Ulysses attention (cp by all-to-all) through the
  flash kernel (a mesh only);
- ``moe``              — switch-routed mixture-of-experts MLPs;
- ``long_context_moe`` — ring attention with group-local expert routing
  (cp x ep; a mesh with an ``expert`` axis only);
- ``flash``            — the same LM with attention through the flash kernel;
- ``rope``             — rotary position embeddings + the flash kernel;
- ``pipelined``        — the GPipe pipeline over a (data, pipe, model) mesh,
  tp and experts inside each stage (a mesh of at least 2 ranks only).

`train_family` runs a family's training step, and `serve_family` its
serving acceptance (a health-checked KV-cache generation, bf16 or the
full int8 stack), on one device or sharded over `family_mesh` of a set
of ranks (dense, flash, rope and moe serve there; moe on `moe_mesh`
where the count divides by 4).  The context-parallel and pipelined
families do not serve (decode has one query position and no microbatch
stream, as the reference says), and the pipelined family refuses one
device with the reference's `pipeline_mesh` error.  Both entry points
report a refusal (``ok=False`` with its reason), honoring the
reference's "reports, never raises" contract.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_dra_torch.parallel.burnin import (
    BurninConfig,
    TrainReport,
    burnin_mesh,
    init_params,
    train,
)
from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.decode import PIPELINE_REFUSAL, make_generate
from tpu_dra_torch.parallel.device import resolve_device
from tpu_dra_torch.parallel.moe import moe_mesh
from tpu_dra_torch.parallel.pipeline import pipeline_mesh, pipeline_sizes
from tpu_dra_torch.parallel.quant import quantize_params
from tpu_dra_torch.parallel.weights import cast_matrices, shard_params

__all__ = [
    "FAMILIES", "ServeReport", "family_config", "family_mesh", "serve_family", "train_family",
]


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
    An unknown name raises."""
    try:
        factory = FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown model family {name!r}; choose from {sorted(FAMILIES)}"
        ) from None
    return factory(**overrides)


def _pipeline_shape(n: int, stages: "int | None") -> "dict[str, int]":
    """The pipelined family's (data, pipe, model) sizes over ``n`` ranks,
    the reference's rule: ``stages`` (default 2) stages, ``model`` 2
    where the count divides by twice the stages.  A count that does not
    factor raises the reference's `pipeline_mesh` error."""
    stages = stages or 2
    model = 2 if n % (stages * 2) == 0 and n >= stages * 2 else 1
    return pipeline_sizes(n, stages=stages, model=model)


def family_mesh(name: str, ranks=None, *, stages: "int | None" = None):
    """The mesh the family shards over, on ``ranks`` (default: every rank
    of the process group): (data, pipe, model) for pipelined
    (`pipeline.pipeline_mesh`, ``stages`` deep, default 2, ``model`` 2
    where the count divides by twice the stages), (data, fsdp, model,
    expert) for moe when the count divides by 4, and always for
    long_context_moe (`moe.moe_mesh`, model 2 x expert 2: the ring owns
    the model axis, so the experts need their own), else
    `burnin.burnin_mesh`.  A count that does not factor raises, as the
    reference's does."""
    if ranks is None:
        ranks = range(dist.get_world_size()) if dist.is_initialized() else [0]
    ranks = list(ranks)
    if name == "pipelined":
        shape = _pipeline_shape(len(ranks), stages)
        return pipeline_mesh(ranks, stages=shape["pipe"], model=shape["model"])
    if name == "long_context_moe" or (name == "moe" and len(ranks) % 4 == 0):
        return moe_mesh(ranks, model=2, expert=2)
    return burnin_mesh(ranks)


def train_family(name: str, mesh=None, *, steps: int = 5,
                 device: "str | torch.device" = "cuda", **overrides) -> TrainReport:
    """Train the named family for ``steps`` steps: on one ``device`` when
    ``mesh`` is None, else sharded over ``mesh`` — a `DeviceMesh`, or the
    ranks to build `family_mesh` over (the reference's ``devices``); every
    rank of it calls this.

    Reports, never raises, for a known family: a config or a mesh the
    port refuses comes back as ``TrainReport(ok=False, error=...)``
    carrying the reason (``long_context`` without a mesh: "requires a
    device mesh", as the reference's forward says; ``pipelined`` on one
    device: the reference's `pipeline_mesh` error for one device)."""
    if name not in FAMILIES:
        family_config(name)  # raises: an unknown name is the caller's error
    try:
        config = family_config(name, **overrides)
        stages = config.pipeline_stages or None
        if mesh is None and name == "pipelined":
            _pipeline_shape(1, stages)  # one device: the reference's mesh refusal
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            mesh = family_mesh(name, mesh, stages=stages)
    except ValueError as e:  # the port refuses the family's fields or mesh
        return TrainReport(
            ok=False, steps=0, loss_first=0.0, loss_last=0.0,
            step_seconds_p50=0.0, tokens_per_second=0.0, error=f"{type(e).__name__}: {e}",
        )
    return train(config, mesh, steps=steps, device=device)


@dataclasses.dataclass
class ServeReport:
    """Result of a family's serving acceptance.  Timing is end to end:
    ``request_ms`` is the wall time of one batched generation, prefill
    and decode, and ``tokens_per_second`` counts its generated tokens
    over that wall."""

    ok: bool
    tokens_per_second: float = 0.0
    request_ms: float = 0.0
    batch: int = 0
    steps: int = 0
    error: str = ""


def serve_family(name: str, mesh=None, *, steps: int = 12, prompt_len: int = 8,
                 int8: bool = False, device: "str | torch.device" = "cuda",
                 **overrides) -> ServeReport:
    """Run the named family's serving acceptance: a health-checked
    generation (`decode.make_generate`) of ``steps`` tokens after a
    ``prompt_len``-token prompt for the config's batch, from
    `init_params`' seeded weights, timed after one warm-up call.
    ``int8=True`` serves the full int8 stack (`quant.quantize_params`
    weights, an int8 KV cache).  On one ``device`` when ``mesh`` is
    None, else sharded over ``mesh`` — a `DeviceMesh`, or the ranks to
    build `family_mesh` over; every rank of it calls this — at the
    config scaled to it (`BurninConfig.scaled_to`): each rank draws the
    whole tree from the same seed on its device, quantizes it when
    ``int8``, and serves its shards (`weights.shard_params`).

    Reports, never raises, for a known family: a config the port rejects
    (context-parallel, pipelined) and a failed or unhealthy generation
    come back as ``ServeReport(ok=False, error=...)``.  The pipelined
    family reports the reference's refusals: its `pipeline_mesh` error
    where the ranks (one device: one) do not factor, else decode's."""
    if name not in FAMILIES:
        family_config(name)  # raises: an unknown name is the caller's error
    try:
        c = family_config(name, **overrides)
        if name == "pipelined":
            if not isinstance(mesh, DeviceMesh):
                _pipeline_shape(1 if mesh is None else len(list(mesh)),
                                c.pipeline_stages or None)
            raise ValueError(PIPELINE_REFUSAL)
        if mesh is None:
            dev = resolve_device(device)
        else:
            if not isinstance(mesh, DeviceMesh):
                mesh = family_mesh(name, mesh)
            c = c.scaled_to(mesh)
            dev = spmd.Place(mesh).device
        gen = make_generate(c, mesh, prompt_len=prompt_len, steps=steps, with_health=True,
                            kv_int8=int8)
        params = init_params(c, device=dev)
        params = quantize_params(params) if int8 else cast_matrices(params)
        if mesh is not None:
            params = shard_params(params, c, mesh, device=dev)
        prompt = torch.ones((c.batch, prompt_len), dtype=torch.int32, device=dev)
        gen(params, prompt)  # warm-up: the allocator, cuBLAS handles
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        toks, healthy = gen(params, prompt)
        healthy = bool(healthy)  # waits for the generation
        dt = time.perf_counter() - t0
        ok = healthy and tuple(toks.shape) == (c.batch, prompt_len + steps)
        error = ""
        if not healthy:
            error = "health check failed: non-finite logits during generation"
        elif not ok:
            error = f"unexpected output shape {tuple(toks.shape)}"
        return ServeReport(
            ok=ok, tokens_per_second=round(c.batch * steps / dt, 1),
            request_ms=round(dt * 1e3, 3), batch=c.batch, steps=steps, error=error,
        )
    except Exception as e:  # the acceptance reports, never crashes its caller
        return ServeReport(ok=False, error=f"{type(e).__name__}: {e}")
