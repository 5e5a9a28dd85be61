"""The one traffic generator: requests from a traffic file's parameters.

A traffic file (``benchmark/traffic/<name>.json``) holds parameters only.
Its ``arrivals`` say how load is offered:

- ``{"kind": "poisson", "rate_per_s": r}``: an open loop.  A window of
  ``seconds`` holds exactly ``round(r * seconds)`` requests, their gaps
  exponential and scaled so that one more would arrive at the window's
  close.
- ``{"kind": "backlog", "depth": n}``: a closed loop that keeps ``n``
  requests waiting; requests are taken in order from a list of
  ``"pool"`` requests (`BACKLOG_POOL` when not given).
- ``{"kind": "steps", "batch": b}``: training batches of ``b`` rows.

``prompt`` and ``output`` give the lengths of prompts and output budgets:
``{"dist": "lognormal", "median": m, "sigma": s, "min": lo, "max": hi}``
(rounded, clipped) or ``{"dist": "uniform", "min": lo, "max": hi}``.

Every seed gets the same schedule: the lengths, budgets and arrival
times are drawn from the file's ``base_seed``, and the run's seed draws
only the prompts' tokens (and, in the drivers, the weights).  So two
seeds offer the same work at the same instants, and the spread between
seeds is the system's, not the draw's: the serving engine's tail latency
follows which budgets overlap in time, and on the card two orders of one
multiset of sizes read 20-30% apart where two runs of one seed read
within 3% (PERF.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

BACKLOG_POOL = 1024  # requests a closed loop can take, unless its file says otherwise


@dataclass(frozen=True)
class Req:
    due_s: float  # arrival, seconds after the window opens (0 for a backlog)
    prompt: "tuple[int, ...]"
    budget: int


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = np.rint(spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n)))
    elif spec["dist"] == "uniform":
        x = rng.integers(lo, hi + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def count(traffic: dict, seconds: float) -> int:
    """Requests in a window of ``seconds`` (the backlog's whole list)."""
    arr = traffic["arrivals"]
    if arr["kind"] == "poisson":
        return max(1, round(arr["rate_per_s"] * seconds))
    if arr["kind"] == "backlog":
        return int(arr.get("pool", BACKLOG_POOL))
    raise ValueError(f"traffic of kind {arr['kind']!r} has no requests")


def requests(traffic: dict, seconds: float, seed: int, vocab: int) -> "list[Req]":
    """The window's requests in arrival order."""
    n = count(traffic, seconds)
    base = np.random.default_rng(int(traffic.get("base_seed", 0)))
    plens = _lengths(traffic["prompt"], n, base)
    budgets = _lengths(traffic["output"], n, base)
    arr = traffic["arrivals"]
    if arr["kind"] == "poisson":
        gaps = base.exponential(1.0, n + 1)
        due = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
    else:
        due = np.zeros(n)
    toks = np.random.default_rng(seed_words(seed, 2))
    return [
        Req(float(due[i]), tuple(int(t) for t in toks.integers(0, vocab, int(plens[i]))),
            int(budgets[i]))
        for i in range(n)
    ]


def seed_words(seed: int, stream: int) -> "list[int]":
    """A seed of any size as 32-bit words, one stream per use."""
    return [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, stream]


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a `torch.Generator`, one stream per use."""
    return (int(seed) * 2_654_435_761 + stream * 40_503) % (1 << 63)


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics); NaN when empty."""
    if not len(values):
        return math.nan
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
