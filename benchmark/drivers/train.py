"""Training driver: the burn-in trainer's step, back to back, each on a
fresh batch.

Set-up makes the f32 weights from the seed, builds the step
(`burnin.make_train_step`) over that state and momentum, and drives it
through its first three steps on fresh batches: these are the steps the
reference follows, and they build and warm the kernels.  It records each
step's loss, each leaf's norm of the first gradient as the optimizer holds
it (momentum starts at zero, so after one step it is the gradient) and,
after the third, each leaf's norm of the change from the starting
weights.  The window runs the same step on further fresh batches, each
loss fetched, until ``seconds`` have passed; its length runs to the end of
its last step.  The traced run profiles two steps in the window's middle.

After the window the memory peak is read, the program's state is freed,
and the plain reference trains from the same weights on the same three
batches in float32.  The numbers compared, each the worst over its
leaves or steps: the loss's gap to the reference's as a share of it, and
for the first gradient and for the change after three steps the gap
between the program's norm of a leaf and the reference's, as a share of
the reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is below a thousandth of the
median leaf's are left out (none of this model's).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import devtrace, traffic as tr, weights
from benchmark.harness import Check, Outcome, Run, sync
from benchmark.reference import model as ref

CHECKED_STEPS = 3
PROFILED_STEPS = 2
ROW_BLOCK = 2  # rows of the reference's forward and backward at a time


def program_config(m: dict, t: dict):
    from tpu_dra_torch.parallel.burnin import BurninConfig

    return BurninConfig(vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
                        d_ff=m["d_ff"], n_layers=m["n_layers"], seq=m["seq"], batch=t["batch"],
                        learning_rate=t["learning_rate"], optimizer=t["optimizer"],
                        flash_attention=t["flash_attention"],
                        moe_experts=m.get("moe_experts", 0))


def trainer(run: Run) -> dict:
    """The cell's trainer settings with the traffic's batch."""
    return {**run.cell["trainer"], "batch": run.traffic["arrivals"]["batch"]}


def batches(run: Run, n: int):
    """The run's first ``n`` batches, drawn on the device from the seed."""
    g = torch.Generator(device=run.device).manual_seed(tr.torch_seed(run.seed, 5))
    b, s = run.traffic["arrivals"]["batch"], run.model["seq"]
    for _ in range(n):
        yield torch.randint(0, run.model["vocab"], (b, s), generator=g, device=run.device,
                            dtype=torch.int32)


def leaf_paths(m: dict) -> "list[str]":
    return [p for p, _, _ in weights.leaves(m)]


@torch.no_grad()
def _norms(tree: dict, paths) -> "dict[str, float]":
    return {p: float(torch.linalg.vector_norm(weights.get(tree, p).float())) for p in paths}


@torch.no_grad()
def _change_norms(run: Run, params: dict, paths) -> "dict[str, float]":
    out = {}
    for p in paths:
        start = weights.make_leaf(run.model, p, run.seed, run.device, torch.float32)
        out[p] = float(torch.linalg.vector_norm(weights.get(params, p) - start))
        del start
    return out


def plant(step, fault: str):
    """A fault under the timed path (tests and controls only)."""
    if fault == "half_batch":
        return lambda state, tokens: step(state, tokens[: tokens.shape[0] // 2])
    if fault == "no_update":
        return lambda state, tokens: (state, step((_copy(state[0]), _copy(state[1])), tokens)[1])
    if fault:
        raise ValueError(f"no fault {fault!r} for a training cell")
    return step


def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def reference(run: Run, fp8: bool = False):
    """The reference's losses, first-gradient norms and change norms over
    the checked steps, from the same weights and batches."""
    m, t = run.model, trainer(run)
    paths = leaf_paths(m)
    params = weights.make_params(m, run.seed, run.device, matrices=torch.float32)
    leaves = [weights.get(params, p).requires_grad_(True) for p in paths]
    mom = [torch.zeros_like(p) for p in leaves]
    losses, g1 = [], {}
    with ref.strict_fp32():
        for step, tokens in enumerate(batches(run, CHECKED_STEPS)):
            tokens = tokens.long()
            B, S = tokens.shape
            grads = [torch.zeros_like(p) for p in leaves]
            total = 0.0
            for lo in range(0, B, ROW_BLOCK):
                rows = tokens[lo:lo + ROW_BLOCK]
                loss = ref.next_token_loss_sum(
                    ref.forward(params, rows, m["n_heads"], fp8=fp8), rows) / (B * (S - 1))
                for g, d in zip(grads, torch.autograd.grad(loss, leaves)):
                    g.add_(d)
                total += float(loss.detach())
            losses.append(total)
            if step == 0:
                g1 = {p: float(torch.linalg.vector_norm(g)) for p, g in zip(paths, grads)}
            with torch.no_grad():
                for p, mo, g in zip(leaves, mom, grads):
                    mo.mul_(0.9).add_(g)
                    p.sub_(mo, alpha=t["learning_rate"])
            del grads
    change = {}
    with torch.no_grad():
        for p, leaf in zip(paths, leaves):
            start = weights.make_leaf(m, p, run.seed, run.device, torch.float32)
            change[p] = float(torch.linalg.vector_norm(leaf - start))
    return losses, g1, change


def leaf_gap(prog: "dict[str, float]", refn: "dict[str, float]", grads: "dict[str, float]"):
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf, over the
    leaves whose reference gradient is not nought to rounding."""
    med_g = float(np.median(list(grads.values())))
    med = float(np.median(list(refn.values())))
    kept = [p for p in refn if grads[p] >= 1e-3 * med_g]
    return max(abs(prog[p] - refn[p]) / max(refn[p], med) for p in kept)


def control(run: Run) -> Outcome:
    """The control: the reference with fp8 products in the program's place."""
    losses, g1, change = reference(run, fp8=True)
    return compare(run, losses, g1, change, Outcome(0, 0, {}, [], 0))


def compare(run: Run, losses, g1, change, out: Outcome) -> Outcome:
    """``out`` with the checks of the program's readings against the reference's."""
    r_losses, r_g1, r_change = reference(run)
    out.checks = [
        Check("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
              run.limit("loss_gap")),
        Check("grad_norm_gap", leaf_gap(g1, r_g1, r_g1), run.limit("grad_norm_gap")),
        Check("update_norm_gap", leaf_gap(change, r_change, r_g1), run.limit("update_norm_gap")),
    ]
    out.readings = {"losses": losses, "ref_losses": r_losses,
                    "grad_gaps": {p: abs(g1[p] - r_g1[p]) / r_g1[p] for p in r_g1},
                    "change_gaps": {p: abs(change[p] - r_change[p]) / r_change[p]
                                    for p in r_change}}
    return out


def run(run: Run) -> Outcome:
    from tpu_dra_torch.parallel.burnin import make_train_step

    if run.variant == "fp8":
        return control(run)
    m, t = run.model, trainer(run)
    cfg = program_config(m, t)
    paths = leaf_paths(m)
    params = weights.make_params(m, run.seed, run.device, matrices=torch.float32)
    mom = {"layers": {k: torch.zeros_like(v) for k, v in params["layers"].items()},
           **{k: torch.zeros_like(v) for k, v in params.items() if k != "layers"}}
    run.mark("weights")
    step, _ = make_train_step(cfg, device=run.device, with_state=False)
    step = plant(step, run.fault)
    run.mark("step_built")
    state = (params, mom)
    stream = batches(run, 1 << 30)

    losses = []
    for i in range(CHECKED_STEPS):
        state, loss = step(state, next(stream))
        losses.append(float(loss))
        if i == 0:
            g1 = _norms(state[1], paths)
    change = _change_norms(run, state[0], paths)
    run.mark("checked_steps")
    if run.trace:
        devtrace.warm()
    run.setup_done()

    t0 = time.perf_counter()
    end = t0 + run.seconds
    walls, trace, window, steps = [], None, None, 0
    while True:
        a = time.perf_counter()
        if a >= end:
            break
        if run.trace and window is None and a >= t0 + run.seconds / 2:
            window, profiled = devtrace.Window(), 0
            window.start()
        with torch.profiler.record_function("bench.train_step"):
            state, loss = step(state, next(stream))
            float(loss)
        steps += 1
        if window is None or trace is not None:
            walls.append(time.perf_counter() - a)  # the profiler's steps run slower
        else:
            profiled += 1
            if profiled == PROFILED_STEPS:
                trace = window.stop()
    t1 = time.perf_counter()
    if window is not None and trace is None:
        trace = window.stop()
    sync(run.devices)
    peak = max((torch.cuda.max_memory_allocated(d) for d in run.devices if d.type == "cuda"),
               default=0)
    tokens_per_step = t["batch"] * m["seq"]
    e2e = {"train_tokens_per_s": steps * tokens_per_step / (t1 - t0)}
    layer = {"kind": "train", "step_walls_s": walls, "batch": t["batch"]}

    del state, params, mom, step
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = Outcome(attempted=steps, failed=0, e2e=e2e, checks=[], memory_peak_bytes=peak,
                  layer=layer, trace=trace)
    return compare(run, losses, g1, change, out)
