"""The port stands alone: nothing under tpu_dra_torch/, and not
chip_smoke.py, imports JAX or the reference package — a GPU host has
neither.  Checked three times: statically over every import statement,
by importing every module of the port in a clean interpreter whose
import system refuses those roots, and by running the entry of the
worker `validate.validate_slice` spawns (whose imports are made inside
it, in a fresh process) in such an interpreter."""

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
    for name in ("burnin", "ckpt", "collectives", "data", "decode", "disagg", "flash", "gang",
                 "mesh", "mfu", "paged", "prefixcache", "quant", "ring", "serve", "spmd", "swap",
                 "ulysses", "validate", "weights", "kernels.flash_attn", "kernels.paged_attn"):
        assert f"tpu_dra_torch.parallel.{name}" in mods
    for name in ("tpu_dra_torch.models", "tpu_dra_torch.fleet", "tpu_dra_torch.fleet.digest",
                 "tpu_dra_torch.fleet.router", "tpu_dra_torch.fleet.stats",
                 "tpu_dra_torch.fleet.fleet",
                 "tpu_dra_torch.api", "tpu_dra_torch.api.topology", "tpu_dra_torch.utils.metrics",
                 "tpu_dra_torch.utils.trace", "tpu_dra_torch.utils.servestats",
                 "tpu_dra_torch.obs.kv", "tpu_dra_torch.obs.requests",
                 "tpu_dra_torch.obs.capacity"):
        assert name in mods


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO_ROOT)
)
def test_no_forbidden_import_statement(path):
    bad = [(line, root) for line, root in _imported_roots(path) if root in FORBIDDEN]
    assert bad == [], f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


TRIPWIRE = (
    "import sys\n"
    "class Tripwire:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
    "            raise AssertionError('port imported ' + name)\n"
    "        return None\n"
    "sys.meta_path.insert(0, Tripwire())\n"
)


def test_importing_the_port_pulls_in_neither_jax_nor_the_reference():
    code = TRIPWIRE + (
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


def test_the_spawned_validate_worker_pulls_in_neither():
    """`validate_slice`'s workers start from a fresh interpreter and make
    their imports inside the worker entry: run that entry in-process, as
    a one-device CPU rank that trains a step, under the tripwire."""
    code = TRIPWIRE + (
        "import queue\n"
        "from tpu_dra_torch.parallel import validate\n"
        "plan = {'device': 'cpu', 'n_local': 1, 'topology': (1, 1, 1), 'axes': [], 'mbytes': 1,\n"
        "        'train_steps': 1, 'gang': None, 'init_method': '', 'timeout_s': 60}\n"
        "out = queue.Queue()\n"
        "validate._worker(0, plan, out)\n"
        "events = [out.get_nowait() for _ in range(out.qsize())]\n"
        "assert [kind for _, kind, _ in events] == ['joined', 'result'], events\n"
        "result = events[-1][2]\n"
        "assert result['error'] == '' and result['train']['steps'] == 2, result\n"
        "print('ok')\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert result.stdout.strip().endswith("ok")


def test_the_workers_sharded_training_stage_pulls_in_neither():
    """The training stage a worker runs on more than one device
    (`validate._train_on_mesh`: the sharded step over `burnin_mesh`) and
    the families it trains over a mesh (ring attention, experts), on a
    one-rank gloo group, under the tripwire."""
    code = TRIPWIRE + (
        "import socket\n"
        "from tpu_dra_torch import models\n"
        "from tpu_dra_torch.parallel import gang, mesh, validate\n"
        "with socket.socket() as s:\n"
        "    s.bind(('127.0.0.1', 0))\n"
        "    port = s.getsockname()[1]\n"
        "gang.join_group(f'tcp://127.0.0.1:{port}', world_size=1, rank=0, device='cpu')\n"
        "result = {'checks': [], 'train': None, 'train_ring': None, 'train_moe': None}\n"
        "validate._train_on_mesh(1, result, mesh.slice_mesh('1x1x1'), [0])\n"
        "assert result['train']['ok'] and result['train']['steps'] == 2, result\n"
        "for name in ('long_context', 'moe', 'flash'):\n"
        "    r = models.train_family(name, [0], steps=2, device='cpu', n_layers=1)\n"
        "    assert r.ok, (name, r)\n"
        "print('ok')\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert result.stdout.strip().endswith("ok")
