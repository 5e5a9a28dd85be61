"""No module of the benchmark imports JAX or the JAX package, comparing
top-level names whole; the reference imports nothing of the program."""

from __future__ import annotations

import ast

from benchmark.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_dra"}


def _top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_in_the_benchmark():
    files = list((REPO / "benchmark").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = FORBIDDEN & set(_top_levels(f))
        assert not bad, f"{f} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in (REPO / "benchmark" / "reference").rglob("*.py"):
        names = set(_top_levels(f))
        assert not names & (FORBIDDEN | {"tpu_dra_torch", "benchmark"}), f


def test_the_scan_compares_whole_names():
    src = REPO / "benchmark" / "drivers" / "serve.py"
    assert "tpu_dra_torch" in set(_top_levels(src))  # the program, allowed
    assert "tpu_dra" not in set(_top_levels(src))
