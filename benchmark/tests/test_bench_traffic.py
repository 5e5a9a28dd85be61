"""The traffic generator: deterministic by seed, and every seed the same
work in another order."""

from __future__ import annotations

import json
from benchmark import traffic as tr
from benchmark.tests.conftest import REPO

CHAT = json.loads((REPO / "benchmark" / "traffic" / "chat-poisson.json").read_text())
BATCH = json.loads((REPO / "benchmark" / "traffic" / "batch-backlog.json").read_text())
CHAT_BACKLOG = json.loads((REPO / "benchmark" / "traffic" / "chat-backlog.json").read_text())


def test_same_seed_same_requests():
    assert tr.requests(CHAT, 5.0, 2**31 + 3, 32768) == tr.requests(CHAT, 5.0, 2**31 + 3, 32768)


def test_seeds_share_the_schedule():
    a = tr.requests(CHAT, 20.0, 1, 32768)
    b = tr.requests(CHAT, 20.0, 2**33 + 7, 32768)
    assert [(r.due_s, len(r.prompt), r.budget) for r in a] == \
        [(r.due_s, len(r.prompt), r.budget) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]


def test_base_seed_draws_the_schedule():
    other = {**CHAT, "base_seed": CHAT["base_seed"] + 1}
    a, b = tr.requests(CHAT, 20.0, 1, 32768), tr.requests(other, 20.0, 1, 32768)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_open_loop_count_and_window():
    reqs = tr.requests(CHAT, 30.0, 5, 32768)
    assert len(reqs) == round(CHAT["arrivals"]["rate_per_s"] * 30.0)
    due = [r.due_s for r in reqs]
    assert due == sorted(due) and 0 < due[0] and due[-1] < 30.0


def test_lengths_clipped_and_tokens_in_vocab():
    for traffic in (CHAT, BATCH, CHAT_BACKLOG):
        for r in tr.requests(traffic, 10.0, 9, 1000):
            assert traffic["prompt"]["min"] <= len(r.prompt) <= traffic["prompt"]["max"]
            assert traffic["output"]["min"] <= r.budget <= traffic["output"]["max"]
            assert all(0 <= t < 1000 for t in r.prompt)


def test_backlog_is_a_list_at_time_zero():
    reqs = tr.requests(BATCH, 10.0, 4, 32768)
    assert len(reqs) == tr.BACKLOG_POOL and all(r.due_s == 0.0 for r in reqs)
    reqs = tr.requests(CHAT_BACKLOG, 10.0, 4, 32768)
    assert len(reqs) == CHAT_BACKLOG["arrivals"]["pool"] and all(r.due_s == 0.0 for r in reqs)


def test_lognormal_median():
    lens = sorted(len(r.prompt) for r in tr.requests(CHAT, 200.0, 1, 32768))
    assert abs(lens[len(lens) // 2] - CHAT["prompt"]["median"]) < 0.1 * CHAT["prompt"]["median"]
