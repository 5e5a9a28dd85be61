"""Multi-turn chat sessions of many tenants: the generator of a traffic
file whose ``arrivals`` kind is ``"sessions"``.

A traffic file holds its parameters: ``tenants`` system prompts of
``system`` tokens each; a session's tenant drawn from a Zipf law of
exponent ``zipf`` over the tenants (``P(i) ~ 1 / i**zipf``, tenant 1 the
most frequent); each turn appends a user turn of ``user`` tokens (a
length spec as `traffic` reads it) to the session's context and asks for
a reply of ``reply`` tokens; the reply joins the context.  A session
ends once its context passes ``max_context`` tokens, or when its next
prompt would not fit the engine's prompt slots (so its contexts stay
within prompt slots plus the longest reply).  ``arrivals`` ``{"kind":
"sessions", "depth": n}``: a closed loop that keeps ``n`` requests
waiting, continuing sessions' turns first and new sessions after them.

Session ``k``'s tenant, user-turn lengths and reply budgets are drawn
from ``(base_seed, k)``, the same for every seed and whatever order the
turns finish in; the tokens of the system prompts and user turns from
the run's seed.  The replies are what the system served.
"""

from __future__ import annotations

import numpy as np

from benchmark import traffic as tr

MAX_TURNS = 64  # more turns than any session's context holds


class Session:
    """One session: its tenant, its context so far, its next turn."""

    def __init__(self, gen: "SessionGen", k: int):
        self.k = k
        rng = np.random.default_rng([int(gen.traffic["base_seed"]), k])
        t = gen.traffic
        self.tenant = int(rng.choice(len(gen.zipf), p=gen.zipf))
        self.user = tr._lengths(t["user"], MAX_TURNS, rng)
        self.reply = tr._lengths(t["reply"], MAX_TURNS, rng)
        self.turn = 0
        self.context = list(gen.system[self.tenant])
        self.gen = gen

    def next_prompt(self) -> "tuple[list[int], int] | None":
        """The next turn's prompt and reply budget, or None: the session
        has ended."""
        g = self.gen
        if len(self.context) > g.traffic["max_context"] or self.turn >= MAX_TURNS:
            return None
        rng = np.random.default_rng(tr.seed_words(g.seed, 1000 + self.k) + [self.turn])
        user = rng.integers(0, g.vocab, int(self.user[self.turn])).tolist()
        prompt = self.context + user
        if len(prompt) > g.prompt_slots:
            return None
        return prompt, int(self.reply[self.turn])

    def answered(self, prompt: "list[int]", reply: "list[int]") -> None:
        self.context = list(prompt) + list(reply)
        self.turn += 1


class SessionGen:
    """Sessions of a traffic file, numbered in the order they start."""

    def __init__(self, traffic: dict, seed: int, vocab: int, prompt_slots: int):
        self.traffic, self.seed, self.vocab, self.prompt_slots = traffic, seed, vocab, prompt_slots
        n = int(traffic["tenants"])
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(traffic["zipf"])
        self.zipf = w / w.sum()
        self.system = [np.random.default_rng(tr.seed_words(seed, 100 + i))
                       .integers(0, vocab, int(traffic["system"])).tolist() for i in range(n)]
        self.started = 0

    def new(self) -> Session:
        s = Session(self, self.started)
        self.started += 1
        return s
