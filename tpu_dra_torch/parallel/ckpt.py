"""Crash-safe checkpoint/resume of the burn-in training state, on one
device or sharded over a `DeviceMesh`, with elastic resume.

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
tree, or AdamW's ``{"m", "v", "t"}`` — and restores bit for bit.  One
device writes it whole (``state.pt``).  On a mesh each rank writes its
own shards, as orbax does (no gather to one rank): ``shard.<i>-of-<n>.pt``
holds the leaves the rank is the first replica of (its place 0 on every
axis the leaf's spec does not name), each with its global slice.  A
restore, onto any mesh or onto one device, reads the slices it needs
from whichever files hold them, so a one-device checkpoint is the case
of one shard whole.  On a mesh the ranks agree throughout: the leader
(the rank at place 0 on every axis) draws the ``.tmp`` name and hands
it to every rank, the leader alone commits after every rank has
fsynced, and a restore that fails on any rank moves every rank to the
previous complete step together.

Elastic resume: `train_with_resume` on a mesh other than the one that
saved (a gang re-formed smaller, or grown back) keeps the shapes frozen
in the runmeta and restores into the new mesh's slices; the frozen
shapes must divide the new mesh (checked up front, with the
reference's words).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import shutil
import uuid

import torch
import torch.distributed as dist

from tpu_dra_torch.parallel import spmd
from tpu_dra_torch.parallel.burnin import (
    BurninConfig,
    make_train_step,
    prepare_tokens,
    state_shardings,
)
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
SHARD_FILE = "shard.{}-of-{}.pt"


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


# -- agreement between the ranks of a mesh ------------------------------------


def _is_leader(place: "spmd.Place") -> bool:
    return all(i == 0 for i in place.coords.values())


def _from_leader(obj, place: "spmd.Place"):
    """The leader's ``obj`` on every rank: a broadcast from index 0 along
    each axis in turn."""
    for axis in place.sizes:
        if place.size(axis) > 1:
            group = place.group(axis)
            box = [obj]
            dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
            obj = box[0]
    return obj


def _all_ok(ok: bool, place: "spmd.Place") -> bool:
    """Whether ``ok`` holds on every rank of the mesh (a barrier too)."""
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=place.device)
    for axis in place.sizes:
        if place.size(axis) > 1:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=place.group(axis))
    return bool(flag.item())


# -- the state as flat leaves ------------------------------------------------


def _flat(tree, prefix: str) -> "dict[str, object]":
    """``{dotted path: leaf}`` of a nested dict (sorted keys)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], f"{prefix}.{key}"))
        return out
    return {prefix: tree}


def _unflat(flat: "dict[str, object]", prefix: str):
    """The inverse of `_flat` for the leaves under ``prefix``."""
    if prefix in flat:
        return flat[prefix]
    tree = {}
    for path, leaf in flat.items():
        if not path.startswith(prefix + "."):
            continue
        node, keys = tree, path[len(prefix) + 1:].split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return tree


def _state_flat(state):
    params, opt = state
    return {**_flat(params, "params"), **_flat(opt, "opt")}


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


def _layout(config: BurninConfig, sizes: "dict[str, int]"):
    """``({path: global shape}, {path: spec})`` of the whole state."""
    shapes = _expected_shapes(config)
    opt_shapes = {"m": shapes, "v": shapes, "t": ()} if config.optimizer == "adamw" else shapes
    specs = state_shardings(config, sizes)
    return ({**_flat(shapes, "params"), **_flat(opt_shapes, "opt")},
            {**_flat(specs[0], "params"), **_flat(specs[1], "opt")})


# -- saving ------------------------------------------------------------------


def save_state(path, state, *, step: int, mesh=None, config: "BurninConfig | None" = None) -> None:
    """Persist ``state`` (``(params, opt)``) at ``path``/<step>, atomically.

    Write, fsync, rename: the state goes into ``.tmp.<step>.<8 hex>``,
    the ``_COMPLETE`` sentinel is fsynced inside it, and the rename to
    ``<step>`` is the commit point (parent fsynced).  Re-saving a step
    that is already committed keeps the committed one; a marker-less
    occupant of the step's name is replaced.

    On a `DeviceMesh` every rank calls this with its shards of the state
    and the ``config`` they were cut by (`burnin.state_shardings`); each
    writes its own file, and the leader commits once every rank's file
    is on disk."""
    root = os.fspath(path)
    os.makedirs(root, exist_ok=True)
    if mesh is None:
        tmp = os.path.join(root, f".tmp.{step}.{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        params, opt = state
        _write_synced(os.path.join(tmp, STATE_FILE),
                      lambda f: torch.save({"params": params, "opt": opt}, f))
        _commit(root, tmp, step)
        return
    if config is None:
        raise ValueError("save_state on a mesh needs the config the state was cut by")
    place = spmd.Place(mesh)
    leader = _is_leader(place)
    tmp = os.path.join(root, _from_leader(
        f".tmp.{step}.{uuid.uuid4().hex[:8]}" if leader else None, place))
    os.makedirs(tmp, exist_ok=True)
    shapes, specs = _layout(config, place.sizes)
    leaves, slices = {}, {}
    for name, leaf in _state_flat(state).items():
        spec = specs[name]
        named = spmd.spec_axes(spec)
        if any(place.index(a) for a in place.sizes if a not in named):
            continue  # another rank writes this replica
        leaves[name] = leaf.detach().contiguous()
        slices[name] = [(s.start, s.stop) for s in
                        spmd.local_slices(spec, shapes[name], place.sizes, place.coords)]
    index, n = 0, 1
    for axis, size in place.sizes.items():
        index, n = index * size + place.index(axis), n * size
    _write_synced(os.path.join(tmp, SHARD_FILE.format(index, n)), lambda f: torch.save(
        {"leaves": leaves, "slices": slices, "shapes": {k: shapes[k] for k in leaves}}, f))
    _all_ok(True, place)  # every rank's file is fsynced
    if leader:
        _commit(root, tmp, step)
    _all_ok(True, place)  # no rank goes on before the commit


def _commit(root: str, tmp: str, step: int) -> None:
    """Mark ``tmp`` complete and rename it to the step's name."""
    _write_synced(os.path.join(tmp, COMPLETE_MARKER), lambda f: f.write(str(step).encode()))
    final = _step_dir(root, step)
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


# -- restoring ---------------------------------------------------------------


def restore_state(path, config: BurninConfig, mesh=None, *, step: "int | None" = None,
                  device: "str | torch.device" = "cuda"):
    """Restore ``(params, opt)``: whole onto ``device``, or on a
    `DeviceMesh` this rank's shards of it (`burnin.state_shardings` of
    ``config``; every rank calls this), from a checkpoint saved on one
    device or on any mesh the config divides.

    ``step=None`` restores the newest complete step, falling back to the
    previous complete step when a restore fails (on a mesh: fails on any
    rank, so that every rank lands on the same step); it raises with
    every attempt's reason when none restores.  An explicit ``step``
    restores exactly that directory (no fallback)."""
    place = spmd.Place(mesh) if mesh is not None else None
    dev = place.device if place is not None else resolve_device(device)
    if step is not None:
        return _restore_step(path, config, dev, step, place)
    return _restore_latest(path, config, dev, place)[0]


def _restore_latest(path, config: BurninConfig, dev: torch.device,
                    place: "spmd.Place | None" = None):
    """``(state, step)`` from the newest complete checkpoint that restores
    (on every rank of ``place``'s mesh)."""
    steps = complete_steps(path)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {path!r}")
    errors = []
    for s in reversed(steps):
        try:
            state, error = _restore_step(path, config, dev, s, place), None
        except Exception as e:  # fall back to the previous complete step
            state, error = None, e
        ok = error is None if place is None else _all_ok(error is None, place)
        if ok:
            return state, s
        reason = error if error is not None else "it failed to restore on another rank"
        logger.warning(
            "checkpoint step %d under %s failed to restore (%s); "
            "falling back to the previous complete step", s, path, reason,
        )
        errors.append(f"step {s}: {reason}")
    raise RuntimeError(
        f"every complete checkpoint under {path!r} failed to restore: " + "; ".join(errors)
    )


def _saved_pieces(step_dir: str):
    """``{path: [(global slices, tensor), ...]}`` and ``{path: global
    shape}`` of every leaf a step directory holds, its files mapped into
    memory (a rank reads only the bytes of the slices it copies)."""
    def load(name):
        return torch.load(name, map_location="cpu", weights_only=True, mmap=True)

    whole = os.path.join(step_dir, STATE_FILE)
    if os.path.exists(whole):
        saved = load(whole)
        flat = _state_flat((saved["params"], saved["opt"]))
        return ({k: [(tuple(slice(0, n) for n in t.shape), t)] for k, t in flat.items()},
                {k: tuple(t.shape) for k, t in flat.items()})
    files = sorted(glob.glob(os.path.join(step_dir, SHARD_FILE.format("*", "*"))))
    if not files:
        raise FileNotFoundError(f"no state file under {step_dir!r}")
    n = int(files[0].rsplit("-of-", 1)[1][:-len(".pt")])
    missing = sorted(set(SHARD_FILE.format(i, n) for i in range(n))
                     - set(os.path.basename(f) for f in files))
    if missing:
        raise FileNotFoundError(f"{step_dir!r} lacks {missing}")
    pieces, shapes = {}, {}
    for name in files:
        saved = load(name)
        for k, t in saved["leaves"].items():
            pieces.setdefault(k, []).append((tuple(slice(a, b) for a, b in saved["slices"][k]), t))
            shapes[k] = tuple(saved["shapes"][k])
    return pieces, shapes


def _restore_step(path, config: BurninConfig, dev: torch.device, step: int,
                  place: "spmd.Place | None" = None):
    pieces, saved_shapes = _saved_pieces(_step_dir(path, step))
    sizes = place.sizes if place is not None else {}
    shapes, specs = _layout(config, sizes)
    if set(pieces) != set(shapes):
        raise ValueError(f"the checkpoint holds {sorted(set(pieces) - set(shapes))} and lacks "
                         f"{sorted(set(shapes) - set(pieces))} of what the config needs")
    out = {}
    for name, shape in shapes.items():
        if saved_shapes[name] != shape:
            raise ValueError(f"{name} is {saved_shapes[name]}, the config needs {shape}")
        if place is None:
            want = tuple(slice(0, n) for n in shape)
        else:
            want = spmd.local_slices(specs[name], shape, place.sizes, place.coords)
        out[name] = _assemble(name, want, pieces[name], dev)
    return _unflat(out, "params"), _unflat(out, "opt")


def _assemble(name: str, want, pieces, dev: torch.device):
    """The block ``want`` (global slices) of a leaf from the saved
    ``pieces`` that overlap it; raises unless they cover it."""
    dtype = pieces[0][1].dtype
    out = torch.empty(tuple(s.stop - s.start for s in want), dtype=dtype, device=dev)
    covered = 0
    for have, t in pieces:
        inter = [slice(max(a.start, b.start), min(a.stop, b.stop)) for a, b in zip(want, have)]
        if any(s.start >= s.stop for s in inter):
            continue
        dst = tuple(slice(s.start - w.start, s.stop - w.start) for s, w in zip(inter, want))
        src = tuple(slice(s.start - h.start, s.stop - h.start) for s, h in zip(inter, have))
        out[dst] = t[src]
        covered += out[dst].numel()
    if covered != out.numel():
        raise ValueError(f"{name}: the saved shards cover {covered} of {out.numel()} elements")
    return out


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


def train_with_resume(config: BurninConfig, path, mesh=None, *, steps: int,
                      save_every: "int | None" = None,
                      device: "str | torch.device" = "cuda"):
    """Run burn-in training with checkpointing, on one ``device`` or
    sharded over a `DeviceMesh` (every rank of it calls this), resuming
    from the newest complete step under ``path`` when there is one.
    Returns ``(final_step, losses)``, ``losses`` covering only the steps
    run in this call, so a resumed run's continuity is checkable against
    an uninterrupted one.

    The run's config is frozen at its first start (``runmeta.json``: on
    a mesh, the config scaled to it).  **Elastic**: a resume on another
    mesh, or on one device, keeps the frozen shapes and restores into the
    new layout's slices; on a mesh the frozen shapes must divide it,
    checked up front (a ValueError naming "elastic resume").

    ``save_every=None`` saves once at the end.  A resume restores without
    first building a fresh state: two copies would double the state's
    memory at the restore."""
    place = spmd.Place(mesh) if mesh is not None else None
    frozen = _read_runmeta(path)
    start = latest_step(path)
    if frozen is not None:
        c = frozen
        if mesh is not None and c.scaled_to(mesh) != c:
            raise ValueError(
                f"checkpointed run shapes (batch={c.batch}, "
                f"d_model={c.d_model}, n_heads={c.n_heads}, d_ff={c.d_ff}, "
                f"seq={c.seq}, vocab={c.vocab}) do not divide the resized "
                f"mesh {spmd.mesh_sizes(mesh)}: elastic resume needs every "
                f"frozen dim to shard evenly on the new mesh"
            )
    else:
        c = config if mesh is None else config.scaled_to(mesh)
    if place is None:
        _write_runmeta(path, c)
        target = dev = resolve_device(device)
    else:
        _all_ok(True, place)  # every rank has read the directory
        if _is_leader(place):
            _write_runmeta(path, c)
        _all_ok(True, place)
        target, dev = mesh, place.device
    if start is not None:
        step_fn, _ = make_train_step(c, target, with_state=False)
        state, start = _restore_latest(path, c, dev, place)
    else:
        step_fn, state = make_train_step(c, target)
        start = 0
    tokens = prepare_tokens(c, target)

    losses = []
    current = start
    for _ in range(steps):
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))
        current += 1
        if save_every and current % save_every == 0:
            save_state(path, state, step=current, mesh=mesh, config=c)
    if steps and (not save_every or current % save_every):
        save_state(path, state, step=current, mesh=mesh, config=c)
    return current, losses
