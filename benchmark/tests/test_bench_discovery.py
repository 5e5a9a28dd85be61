"""Every configuration, cell, traffic mix, driver and metric reader is
found by its name, and a cell added as files alone runs."""

from __future__ import annotations

import json

from benchmark import harness
from benchmark.tests.conftest import REPO, run_tiny

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
B = REPO / "benchmark"


def test_each_workload_has_its_files():
    for w in BENCH["workloads"]:
        _, entry, cell, config, traffic = harness.load_cell(REPO, w["name"])
        assert entry is not None and config["model"] and traffic["arrivals"]
        assert (B / "drivers" / f"{cell['driver']}.py").is_file()
        assert cell["limits"] and all(v is not None for v in cell["limits"].values())


def test_each_config_file_is_named_in_benchmark_json():
    named = {c["file"] for c in BENCH["configs"]}
    assert named == {f"benchmark/configs/{p.name}" for p in (B / "configs").glob("*.json")}
    for c in BENCH["configs"]:
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]


def test_each_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        mod = harness.load_module(B / "metrics" / f"{m['name']}.py", "t_" + m["name"])
        assert callable(mod.read)
        for w in m["workloads"]:
            assert any(x["name"] == w for x in BENCH["workloads"])


def test_metrics_for_a_cell():
    chat = harness.find_workload(BENCH, "dense-chat")
    assert {m["name"] for m in harness.metrics_for(BENCH, "end_to_end", chat)} == {
        "output_tokens_per_s.chat", "tpot_p95_ms.chat", "setup_s"}
    moe = harness.find_workload(BENCH, "moe-batch")
    assert {m["name"] for m in harness.metrics_for(BENCH, "end_to_end", moe)} == {
        "output_tokens_per_s", "tpot_p95_ms", "setup_s"}
    train = harness.find_workload(BENCH, "dense-train")
    assert {m["name"] for m in harness.metrics_for(BENCH, "per_layer", train)} == {
        "mfu.train", "k2_roofline.train", "device_idle.train"}


def test_a_cell_added_as_files_runs(tiny_root):
    # tiny_root holds the committed benchmark plus tiny cells, traffic and
    # configurations added as new files and BENCHMARK.json entries only.
    line, _ = run_tiny(tiny_root, "tiny-chat")
    assert line["attempted"] > 0 and line["correct"]
    assert set(line["metrics"]) == {"output_tokens_per_s.chat", "tpot_p95_ms.chat", "setup_s"}


def test_a_metric_added_as_a_file_is_read(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "ticks.chat", "unit": "ticks", "better": "higher",
                               "source": "program_counter", "layer": "engine tick",
                               "moves": "tpot_p95_ms.chat", "workloads": ["tiny-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "metrics" / "ticks.chat.py").write_text(
        "def read(ctx):\n    return float(len(ctx.layer['ticks']))\n")
    line, _ = run_tiny(root, "tiny-chat", trace=True)
    assert line["metrics"]["ticks.chat"]["value"] > 0
