"""The decode kernels' launch counts, ``launches`` on each kernel's
entry (K1's `paged_attention`, K3's `mla_decode`), under one rule:
exact from any thread (a fleet's replicas launch from their own, and
``+= 1`` is a read and a write another thread's update can fall
between); a thread's launches inside `uncounted` (a decode graph's
warm-up on scratch and its capture, which serve no step) left out, and
a graph's replays counted by `add`."""

from __future__ import annotations

import contextlib
import threading

_LOCK = threading.Lock()
# ``off`` is true on a thread inside `uncounted`.
_UNCOUNTED = threading.local()


def add(entry, n: int) -> None:
    """Add ``n`` to ``entry.launches``."""
    with _LOCK:
        entry.launches += n


def launched(entry) -> None:
    """One launch of ``entry``'s kernel, counted outside `uncounted`."""
    if not getattr(_UNCOUNTED, "off", False):
        add(entry, 1)


@contextlib.contextmanager
def uncounted():
    """Launches this thread makes inside the block are not counted."""
    _UNCOUNTED.off = True
    try:
        yield
    finally:
        _UNCOUNTED.off = False
