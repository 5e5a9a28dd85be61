"""The latent-attention cell's and the fleet cell's drivers at a tiny
size on the CPU, added as files the way their real cells are: a sound
run correct and a planted fault not; their per-layer readers; the
session generator; and the Moonlight configuration file against the
published keys it holds twice (at the top level, and under ``model`` for
the harness)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark.tests.conftest import REPO, TINY, add_cell, run_tiny

TINY_MLA = {
    "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
    "q_lora_rank": None, "kv_lora_rank": 32, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
    "v_head_dim": 32, "intermediate_size": 128, "moe_intermediate_size": 32,
    "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
    "first_k_dense_replace": 1, "routed_scaling_factor": 2.446, "norm_topk_prob": True,
    "n_group": 1, "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 50000,
    "max_position_embeddings": 512, "tie_word_embeddings": False,
}
# Limits of the tiny cells from their own CPU readings: a sound run reads
# a third of each or less, the planted fault three times one or more.
CELLS = {
    "tiny-mla": ({"config": "tiny-mla", "traffic": "tiny-reason", "chips": 1,
                  "driver": "serve_mla",
                  "engine": {"slots": 4, "prompt_slots": 32, "max_new_cap": 24,
                             "prefix_window": 8, "attn_backend": "cuda", "kv_layout": "paged",
                             "prefix_cache_slots": 0, "telemetry": True},
                  "route_margin": 0.03,
                  "limits": {"served_gap_mean": 0.05, "route_mismatches": 0}},
                 {"arrivals": {"kind": "backlog", "depth": 4, "pool": 64},
                  "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.6, "min": 4, "max": 32},
                  "output": {"dist": "uniform", "min": 2, "max": 8}, "base_seed": 1},
                 "moonlight-reason"),
    "tiny-fleet": ({"config": "tiny-lm", "traffic": "tiny-sessions", "chips": 1,
                    "driver": "fleet", "replicas": 2,
                    "engine": {"slots": 4, "prompt_slots": 64, "max_new_cap": 32,
                               "prefix_window": 16, "attn_backend": "cuda",
                               "kv_layout": "paged", "prefix_cache_slots": 4,
                               "telemetry": True},
                    "limits": {"served_gap_mean": 1e-3}},
                   {"arrivals": {"kind": "sessions", "depth": 4}, "tenants": 3, "system": 16,
                    "zipf": 1.1,
                    "user": {"dist": "lognormal", "median": 6, "sigma": 0.6, "min": 2, "max": 12},
                    "reply": {"dist": "uniform", "min": 2, "max": 8}, "max_context": 56,
                    "base_seed": 17},
                   "fleet4-sessions"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    configs = root / "benchmark" / "configs"
    (configs / "tiny-mla.json").write_text(json.dumps({"model": TINY_MLA}))
    (configs / "tiny-lm.json").write_text(json.dumps(
        {"model": {**TINY, "moe_experts": 0, "moe_capacity": 1.25}}))
    for name, (cell, traffic, stands_for) in CELLS.items():
        add_cell(root, name, cell, traffic, stands_for)
    return root


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(root, cell):
    line, checks = run_tiny(root, cell, seconds=3.0)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c.value <= c.limit / 3 for c in checks if c.limit), line["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_planted_fault_is_not_correct(root, cell):
    line, checks = run_tiny(root, cell, seconds=3.0, fault="token")
    assert not line["correct"]
    assert any(c.value >= 3 * c.limit for c in checks if c.limit), line["checks"]


def test_traced_runs_read_their_counters(root):
    line, _ = run_tiny(root, "tiny-mla", seconds=3.0, trace=True)
    assert line["metrics"]["expert_load.mla"]["value"] >= 1.0
    assert "mfu.mla" not in line["metrics"]  # no card: no peak to share
    line, _ = run_tiny(root, "tiny-fleet", seconds=3.0, trace=True)
    assert 0 <= line["metrics"]["affinity_rate.fleet"]["value"] <= 100
    assert 0 < line["metrics"]["prefill_reuse.fleet"]["value"] <= 100
    assert 0 < line["metrics"]["replica_busy.fleet"]["value"] <= 100


def test_sessions_share_system_prompts_and_grow():
    from benchmark.sessions import SessionGen

    traffic = CELLS["tiny-fleet"][1]
    gen = SessionGen(traffic, 2**33 + 5, 512, 64)
    a, b = gen.new(), SessionGen(traffic, 7, 512, 64).new()
    assert a.tenant == b.tenant  # the schedule is the base seed's
    prompt, budget = a.next_prompt()
    assert prompt[:16] == gen.system[a.tenant] and 2 <= budget <= 8
    a.answered(prompt, [1] * budget)
    nxt, _ = a.next_prompt()
    assert nxt[:len(prompt) + budget] == prompt + [1] * budget
    counts = [0] * 3
    for _ in range(300):
        counts[gen.new().tenant] += 1
    assert counts[0] > counts[1] > counts[2]  # Zipf


def test_moonlight_config_holds_the_published_keys():
    cfg = json.loads((REPO / "benchmark" / "configs" / "moonlight-16b-a3b.json").read_text())
    published = {k: v for k, v in cfg.items() if k not in ("name", "source", "reduced",
                                                          "assumed", "model")}
    assert cfg["model"] == published and cfg["reduced"] == []
    assert published["num_hidden_layers"] == 27 and published["n_routed_experts"] == 64
    assert len(cfg["source"]) <= 200


def test_reference_copy_is_the_tests_reference():
    assert (REPO / "benchmark" / "reference" / "mla_moe.py").read_text() == \
        (REPO / "tests" / "ref_mla_moe.py").read_text()
