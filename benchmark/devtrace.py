"""A profiled sub-window: `torch.profiler` over a few seconds of the run,
read back as the device's kernels and the host's operations.

The trace is exported as a Chrome trace into a fresh directory under
``TMPDIR``, read, and deleted.  Device work is every event of the kinds
in `DEVICE_CATS`; the window is the host's clock from the profiler's
start to its stop, each side synchronised with the device, so the idle
share divides by the window and not by the kernels' span.
"""

from __future__ import annotations

import bisect
import json
import shutil
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10


@dataclass
class DeviceTrace:
    window_s: float
    # (name, start_us, dur_us, device index) of each device operation
    device: "list[tuple[str, float, float, int]]" = field(default_factory=list)
    # (name, start_us, dur_us, thread) of each host operation
    host: "list[tuple[str, float, float, int]]" = field(default_factory=list)

    def devices(self) -> "list[int]":
        return sorted({d for *_, d in self.device})

    def kernel_times(self, substring: str) -> "list[float]":
        """Seconds of each device operation whose name holds ``substring``."""
        return [dur * 1e-6 for name, _, dur, _ in self.device if substring in name]

    def busy_s(self, device: int) -> float:
        """Seconds in which some operation ran on ``device`` (their union)."""
        return sum(b - a for a, b in _union(self._intervals(device))) * 1e-6

    def _intervals(self, device: int):
        return sorted((s, s + d) for _, s, d, dev in self.device if dev == device)

    def mean_busy_s(self) -> float:
        devs = self.devices()
        return sum(self.busy_s(d) for d in devs) / len(devs) if devs else 0.0

    def top_device_ops(self) -> "list[list]":
        total: "dict[str, float]" = defaultdict(float)
        for name, _, dur, _ in self.device:
            total[_short(name)] += dur * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> "list[list]":
        """The device's idle gaps summed by what the host was doing in
        their middle (the innermost host operation open there)."""
        by_thread: "dict[int, list]" = defaultdict(list)
        for name, s, d, tid in self.host:
            by_thread[tid].append((s, s + d, name))
        starts = {}
        for tid, evs in by_thread.items():
            evs.sort()
            starts[tid] = [e[0] for e in evs]
        total: "dict[str, float]" = defaultdict(float)
        for dev in self.devices():
            iv = _union(self._intervals(dev))
            for (_, a), (b, _) in zip(iv, iv[1:]):
                mid = (a + b) / 2
                best = None
                for tid, evs in by_thread.items():
                    i = bisect.bisect_right(starts[tid], mid) - 1
                    for j in range(i, max(-1, i - 256), -1):
                        s, e, name = evs[j]
                        if e >= mid:
                            if best is None or s > best[0]:
                                best = (s, name)
                            break
                total[_short(best[1]) if best else "(no host operation)"] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def _union(intervals):
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _sync():
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def warm() -> None:
    """Start and stop the profiler once over a trivial operation: its first
    start in a process initialises the device tracer, which takes seconds
    and would eat into a profiled window."""
    w = Window()
    w.start()
    torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
    w._prof.__exit__(None, None, None)


class Window:
    """``start()`` the profiler, run work, ``stop()`` to get the trace."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._t0 = 0.0

    def start(self) -> None:
        _sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        _sync()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        tmp = tempfile.mkdtemp(prefix="bench-trace-")
        try:
            path = f"{tmp}/trace.json"
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out = DeviceTrace(window_s=window)
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                out.device.append((ev.get("name", ""), float(ev["ts"]), float(ev["dur"]),
                                   int(ev.get("args", {}).get("device", 0))))
            elif cat in HOST_CATS:
                out.host.append((ev.get("name", ""), float(ev["ts"]), float(ev["dur"]),
                                 int(ev.get("tid", 0)) if str(ev.get("tid", 0)).isdigit() else 0))
        return out
