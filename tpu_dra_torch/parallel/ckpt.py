"""Crash-safe checkpoint/resume of the burn-in training state, one device.

Counterpart of `tpu_dra.parallel.ckpt`, with `torch.save`/`torch.load`
in place of orbax.  The commit protocol and the directory layout are
the reference's, so the two packages read the same trees the same way:

- every step commits atomically: the state is written into a hidden
  ``.tmp.<step>.<8 hex>`` directory and fsynced, a ``_COMPLETE`` marker
  is fsynced inside it, and only then is the directory renamed to
  ``<step>`` (the commit point; the parent is fsynced after).  A kill at
  any instant leaves a complete step directory or a ``.tmp`` orphan,
  which `complete_steps` ignores;
- `restore_state` with no step walks the complete steps newest first
  and falls back to the previous one when a restore fails (a file torn
  away under a surviving marker, bit rot);
- ``runmeta.json`` freezes the run's config at its first start, in the
  reference's schema.

The saved state is ``(params, opt)`` — the f32 masters and the momentum
tree, or AdamW's ``{"m", "v", "t"}`` — and restores bit for bit onto the
device asked for.  The reference's mesh shardings and its elastic
resume on a resized mesh wait for the port's sharded training.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import uuid

import torch

from tpu_dra_torch.parallel.burnin import BurninConfig, make_train_step, prepare_tokens
from tpu_dra_torch.parallel.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "COMPLETE_MARKER",
    "RUNMETA",
    "complete_steps",
    "latest_step",
    "restore_state",
    "save_state",
    "train_with_resume",
]

COMPLETE_MARKER = "_COMPLETE"
RUNMETA = "runmeta.json"
STATE_FILE = "state.pt"


def _fsync_dir(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_synced(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_state(path, state, *, step: int) -> None:
    """Persist ``state`` (``(params, opt)``) at ``path``/<step>, atomically.

    Write, fsync, rename: the state goes into ``.tmp.<step>.<8 hex>``,
    the ``_COMPLETE`` sentinel is fsynced inside it, and the rename to
    ``<step>`` is the commit point (parent fsynced).  Re-saving a step
    that is already committed keeps the committed one; a marker-less
    occupant of the step's name is replaced."""
    root = os.fspath(path)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp.{step}.{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    params, opt = state
    _write_synced(os.path.join(tmp, STATE_FILE),
                  lambda f: torch.save({"params": params, "opt": opt}, f))
    _write_synced(os.path.join(tmp, COMPLETE_MARKER), lambda f: f.write(str(step).encode()))
    final = _step_dir(path, step)
    if os.path.exists(os.path.join(final, COMPLETE_MARKER)):
        # Idempotent re-save of an already committed step (a retried
        # preemption window): the committed directory wins.
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        if os.path.exists(final):
            # A marker-less (truncated) occupant: the fresh commit replaces
            # it, or the run would retrain and discard this step forever.
            shutil.rmtree(final)
        os.rename(tmp, final)
    _fsync_dir(root)


def restore_state(path, config: BurninConfig, *, step: "int | None" = None,
                  device: "str | torch.device" = "cuda"):
    """Restore ``(params, opt)`` onto ``device``.

    ``step=None`` restores the newest complete step, falling back to the
    previous complete step when a restore fails; it raises with every
    attempt's reason when none restores.  An explicit ``step`` restores
    exactly that directory (no fallback)."""
    dev = resolve_device(device)
    if step is not None:
        return _restore_step(path, config, dev, step)
    return _restore_latest(path, config, dev)[0]


def _restore_latest(path, config: BurninConfig, dev: torch.device):
    """``(state, step)`` from the newest restorable complete checkpoint."""
    steps = complete_steps(path)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {path!r}")
    errors = []
    for s in reversed(steps):
        try:
            return _restore_step(path, config, dev, s), s
        except Exception as e:  # fall back to the previous complete step
            logger.warning(
                "checkpoint step %d under %s failed to restore (%s); "
                "falling back to the previous complete step", s, path, e,
            )
            errors.append(f"step {s}: {e}")
    raise RuntimeError(
        f"every complete checkpoint under {path!r} failed to restore: " + "; ".join(errors)
    )


def _expected_shapes(c: BurninConfig):
    """The parameter tree's leaf shapes for ``c`` (`burnin.init_params`'
    layout)."""
    L, D, F, E = c.n_layers, c.d_model, c.d_ff, c.moe_experts
    if E > 0:
        mlp = {"router": (L, D, E), "w1e": (L, E, D, F), "w2e": (L, E, F, D)}
    else:
        mlp = {"w1": (L, D, F), "w2": (L, F, D)}
    layers = {"wqkv": (L, D, 3, c.n_heads, c.d_head), "wo": (L, c.n_heads, c.d_head, D),
              **mlp, "ln1": (L, D), "ln2": (L, D)}
    return {"embed": (c.vocab, D), "pos": (c.seq, D), "layers": layers, "ln_f": (D,)}


def _check_tree(tree, shapes, where: str) -> None:
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            raise ValueError(f"{where} holds {sorted(tree) if isinstance(tree, dict) else type(tree)}"
                             f", the config needs {sorted(shapes)}")
        for name, sub in shapes.items():
            _check_tree(tree[name], sub, f"{where}.{name}")
    elif not torch.is_tensor(tree) or tuple(tree.shape) != shapes:
        got = tuple(tree.shape) if torch.is_tensor(tree) else type(tree).__name__
        raise ValueError(f"{where} is {got}, the config needs {shapes}")


def _restore_step(path, config: BurninConfig, dev: torch.device, step: int):
    with open(os.path.join(_step_dir(path, step), STATE_FILE), "rb") as f:
        saved = torch.load(f, map_location=dev, weights_only=True)
    shapes = _expected_shapes(config)
    _check_tree(saved["params"], shapes, "params")
    opt = saved["opt"]
    if config.optimizer == "adamw":
        _check_tree(opt, {"m": shapes, "v": shapes, "t": ()}, "opt")
    else:
        _check_tree(opt, shapes, "opt")
    return saved["params"], opt


def complete_steps(path) -> "list[int]":
    """Sorted steps under ``path`` whose directories carry the
    ``_COMPLETE`` sentinel.  Tmp orphans (non-digit names) and truncated
    step directories (a digit name, no sentinel) are both skipped."""
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    steps = []
    for name in names:
        if not name.isdigit():
            continue
        if os.path.exists(os.path.join(path, name, COMPLETE_MARKER)):
            steps.append(int(name))
    return sorted(steps)


def latest_step(path) -> "int | None":
    """Highest complete step saved under ``path``, or None when empty or
    absent."""
    steps = complete_steps(path)
    return steps[-1] if steps else None


def _step_dir(path, step: int) -> str:
    return os.path.join(os.fspath(path), str(step))


# -- run metadata: the config frozen at the run's first start ----------------


def _write_runmeta(path, config: BurninConfig) -> None:
    """Record the run's config atomically, in the reference's schema (the
    config's fields as one JSON object).  An existing runmeta is left
    alone: the first writer froze the shapes for the life of the run."""
    root = os.fspath(path)
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, RUNMETA)
    if os.path.exists(final):
        return
    tmp = final + ".tmp"
    _write_synced(tmp, lambda f: f.write(json.dumps(dataclasses.asdict(config)).encode()))
    os.rename(tmp, final)
    _fsync_dir(root)


def _read_runmeta(path) -> "BurninConfig | None":
    """The frozen config, or None (a directory without a runmeta)."""
    try:
        with open(os.path.join(os.fspath(path), RUNMETA)) as f:
            return BurninConfig(**json.load(f))
    except FileNotFoundError:
        return None


def train_with_resume(config: BurninConfig, path, *, steps: int,
                      save_every: "int | None" = None,
                      device: "str | torch.device" = "cuda"):
    """Run burn-in training with checkpointing on one device, resuming
    from the newest complete step under ``path`` when there is one (with
    the config frozen in its runmeta).  Returns ``(final_step, losses)``,
    ``losses`` covering only the steps run in this call, so a resumed
    run's continuity is checkable against an uninterrupted one.

    ``save_every=None`` saves once at the end.  A resume restores without
    first building a fresh state: two copies would double the state's
    memory at the restore."""
    dev = resolve_device(device)
    c = _read_runmeta(path) or config
    _write_runmeta(path, c)
    start = latest_step(path)
    if start is not None:
        step_fn, _ = make_train_step(c, dev, with_state=False)
        state, start = _restore_latest(path, c, dev)
    else:
        step_fn, state = make_train_step(c, dev)
        start = 0
    tokens = prepare_tokens(c, dev)

    losses = []
    current = start
    for _ in range(steps):
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))
        current += 1
        if save_every and current % save_every == 0:
            save_state(path, state, step=current)
    if steps and (not save_every or current % save_every):
        save_state(path, state, step=current)
    return current, losses
