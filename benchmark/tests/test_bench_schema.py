"""BENCHMARK.json within the contract's limits, and the result line's
schema."""

from __future__ import annotations

import json
import math
import re

from benchmark.tests.conftest import REPO, run_tiny

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in BENCH[k]}) == len(BENCH[k])
        for m in BENCH[k]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_end_to_end_bounds_and_coverage():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for w in BENCH["workloads"]:
        mine = [m for m in e2e.values() if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]]["workloads"]


def test_four_chip_cells_at_most_a_quarter():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_result_line_schema(tiny_root):
    line, checks = run_tiny(tiny_root, "tiny-train")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["correct"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["checks"]) == {c.name for c in checks}
    json.dumps(line)


def test_traced_line_has_busy_window_and_breakdown(tiny_root):
    line, _ = run_tiny(tiny_root, "tiny-chat", trace=True)
    assert "busy_s" in line["device"] and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device here: the readers of device metrics find nothing and are left out.
    assert "k1_roofline.chat" not in line["metrics"]
    assert {"admit_share.chat", "dispatch_share.chat"} <= set(line["metrics"])
