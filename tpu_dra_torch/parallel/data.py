"""Input pipeline: host-side batch streams with device prefetch.

Counterpart of `tpu_dra.parallel.data`, on one device or on a rank of
a `DeviceMesh`:

- `synthetic_stream`   — an infinite, seeded iterator of fresh training
  batches, the reference's batches bit for bit (the port's Threefry,
  `prng`, drawn on the host);
- `prefetch_to_device` — wrap any batch iterator with a depth-``size``
  device prefetch: each batch is copied from pinned host memory on a
  side CUDA stream, and the consumer's stream waits on that copy's event
  before the batch is used, so copies overlap the steps in flight.  On a
  mesh (the reference's ``sharding``) a rank copies only its block of
  each batch (`spmd.local_slices` of a spec, `burnin.token_spec` for
  training), the rest never leaving the host;
- `train_on_stream`    — the stream-fed training loop: a fresh
  prefetched batch a step, the same `TrainReport` as `burnin.train`; on
  a mesh, the config scaled to it and the sharded step.
"""

from __future__ import annotations

import collections
import time

import torch

from tpu_dra_torch.parallel import prng, spmd
from tpu_dra_torch.parallel.burnin import (
    BurninConfig,
    TrainReport,
    assemble_train_report,
    make_train_step,
    sample_tokens,
    token_spec,
)
from tpu_dra_torch.parallel.device import resolve_device

__all__ = ["prefetch_to_device", "synthetic_stream", "train_on_stream"]


def synthetic_stream(config: BurninConfig, *, seed: int = 0):
    """Infinite iterator of fresh ``(batch, seq)`` int32 token batches on
    the host, deterministic in ``seed``: the reference's stream (``key,
    sub = split(key)``, then `burnin.sample_tokens` from ``sub``) bit for
    bit."""
    key = prng.key(seed)
    while True:
        key, sub = prng.split(key)
        yield sample_tokens(config, device="cpu", key=sub)


class _Prefetch:
    """The iterator `prefetch_to_device` returns.  ``stream`` is the side
    stream the copies run on (None on the CPU) and ``waits`` counts the
    batches handed out after the consumer's stream waited on their copy.
    ``block`` takes a host batch to the part of it this rank copies."""

    def __init__(self, iterator, size: int, device: torch.device, block=None):
        self._source = iter(iterator)
        self._device = device
        self._block = block
        self._queue = collections.deque()
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.waits = 0
        self._exhausted = False
        self._fill(size)

    def _put(self, batch) -> None:
        batch = torch.as_tensor(batch)
        if self._block is not None:
            batch = self._block(batch)
        if self.stream is None:
            self._queue.append((batch.to(self._device), None, None))
            return
        # The pinned copy stays referenced in the queue until its batch is
        # handed out, and the caching host allocator holds it beyond that
        # until the copy's event has passed: the copy never reads freed memory.
        pinned = batch.pin_memory()
        with torch.cuda.stream(self.stream):
            on_device = pinned.to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._queue.append((on_device, done, pinned))

    def _fill(self, size: int) -> None:
        for batch in self._source:
            self._put(batch)
            if len(self._queue) == size:
                return
        self._exhausted = True

    def __iter__(self):
        return self

    def __next__(self):
        if not self._queue:
            raise StopIteration
        on_device, done, _ = self._queue.popleft()
        if not self._exhausted:
            try:
                self._put(next(self._source))
            except StopIteration:
                self._exhausted = True
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            # Allocated on the side stream, used on the consumer's: the
            # allocator must not hand its memory out again before the
            # consumer's work on it is done.
            on_device.record_stream(consumer)
            self.waits += 1
        return on_device


def prefetch_to_device(iterator, *, size: int = 2, device: "str | torch.device" = "cuda",
                       mesh=None, spec=None):
    """Depth-``size`` device prefetch over any host batch iterator.

    On a card, ``size`` batches are kept in flight: each is pinned and
    copied with ``non_blocking`` on a side stream, an event recorded after
    its copy, and the consumer's current stream waits on that event when
    the batch is handed out, so the host never blocks on a copy and a
    step never reads a batch before its copy is done.  On the CPU it
    passes the batches through in order.  Contents and order are the
    iterator's whatever ``size``.

    On a `DeviceMesh` (the reference's ``sharding``) each batch is placed
    in the layout ``spec`` gives it (`burnin.token_spec` for the training
    batch; None: whole on every rank): the rank takes its block of the
    host batch (`spmd.local_slices`) and copies only that, the same way,
    to its own device (``device`` is then the rank's)."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    if mesh is None:
        return _Prefetch(iterator, size, resolve_device(device))
    place = spmd.Place(mesh)

    def block(batch):
        if spec is None:
            return batch
        return batch[spmd.local_slices(spec, batch.shape, place.sizes, place.coords)].contiguous()

    return _Prefetch(iterator, size, place.device, block)


def train_on_stream(config: BurninConfig, mesh=None, *, steps: int = 5, seed: int = 0,
                    prefetch: int = 2, device: "str | torch.device" = "cuda") -> TrainReport:
    """The stream-fed training loop: ``max(2, steps)`` steps, each on a
    fresh prefetched batch of `synthetic_stream`, from `init_params`'
    seeded weights.  On a `DeviceMesh` (every rank of it calls this) the
    config is scaled to the mesh first, as `burnin.train` scales it, each
    rank copies its rows of every batch (`burnin.token_spec`) and the
    step is the sharded one.  Same report contract as `burnin.train`
    (loss first against last, over distinct batches); reports, never
    raises."""
    try:
        if mesh is None:
            dev = resolve_device(device)
            step_fn, state = make_train_step(config, dev)
            stream = prefetch_to_device(synthetic_stream(config, seed=seed), size=prefetch,
                                        device=dev)
        else:
            config = config.scaled_to(mesh)
            step_fn, state = make_train_step(config, mesh)
            stream = prefetch_to_device(synthetic_stream(config, seed=seed), size=prefetch,
                                        mesh=mesh, spec=token_spec(config))
        losses, times = [], []
        for _ in range(max(2, steps)):
            batch = next(stream)
            t0 = time.perf_counter()
            state, loss = step_fn(state, batch)
            losses.append(float(loss))  # waits for the step
            times.append(time.perf_counter() - t0)
        return assemble_train_report(config, losses, times)
    except Exception as e:  # burn-in reports, never crashes its caller
        return TrainReport(
            ok=False, steps=0, loss_first=0.0, loss_last=0.0,
            step_seconds_p50=0.0, tokens_per_second=0.0,
            error=f"{type(e).__name__}: {e}",
        )
