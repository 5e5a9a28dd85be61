"""The port stands alone: nothing under tpu_dra_torch/, and not
chip_smoke.py, imports JAX or the reference package — a GPU host has
neither.  Checked twice: statically over every import statement, and by
importing every module of the port in a clean interpreter whose import
system refuses those roots."""

import ast
import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "tpu_dra")


def _port_files():
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO_ROOT, "tpu_dra_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def _modules():
    out = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO_ROOT)[:-3].split(os.sep)
        if rel[-1] == "__init__":
            rel = rel[:-1]
        out.append(".".join(rel))
    return out


def test_port_has_the_slice_modules():
    mods = set(_modules())
    for name in ("burnin", "decode", "disagg", "flash", "mfu", "paged", "prefixcache", "quant",
                 "ring", "serve", "swap", "weights", "kernels.flash_attn", "kernels.paged_attn"):
        assert f"tpu_dra_torch.parallel.{name}" in mods
    for name in ("tpu_dra_torch.models", "tpu_dra_torch.fleet", "tpu_dra_torch.fleet.digest"):
        assert name in mods


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO_ROOT)
)
def test_no_forbidden_import_statement(path):
    bad = [(line, root) for line, root in _imported_roots(path) if root in FORBIDDEN]
    assert bad == [], f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


def test_importing_the_port_pulls_in_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "class Tripwire:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise AssertionError('port imported ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Tripwire())\n"
        "import importlib\n"
        f"for name in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert result.stdout.strip().endswith("ok")
