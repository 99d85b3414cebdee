"""(g) The port imports neither JAX, the JAX package nor PIL.

An AST scan of every module of ``syzygy_tpu_torch/`` and of
``chip_smoke.py``, plus a fresh interpreter that imports every port module
and then finds no ``jax``/``syzygy_tpu``/``PIL`` in ``sys.modules``.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "syzygy_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "syzygy_tpu", "PIL"}


def _port_files():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _modules():
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[: -len(".py")]
        if rel == "chip_smoke":
            continue
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


@pytest.mark.parametrize("path", list(_port_files()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        bad = FORBIDDEN.intersection(roots)
        assert not bad, f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {sorted(bad)}"


@pytest.mark.parametrize(
    "module",
    [
        "syzygy_tpu_torch.tools.gather_bench",
        "syzygy_tpu_torch.kernels.gather",
        "syzygy_tpu_torch.kernels.build",
        "syzygy_tpu_torch.assets.gltf",
        "syzygy_tpu_torch.assets.gltf_export",
        "syzygy_tpu_torch.assets.chess",
        "syzygy_tpu_torch.assets.showcase",
        "syzygy_tpu_torch.app.scenes",
        "syzygy_tpu_torch.app.serve",
        "syzygy_tpu_torch.app.properties",
        "syzygy_tpu_torch.scene.serialize",
        "syzygy_tpu_torch.utils.metrics",
        "syzygy_tpu_torch.utils.log",
    ],
)
def test_scans_cover_module(module):
    """The AST scan and the fresh-interpreter import reach every module,
    the glTF path, the gather kernel, the tools, the viewer and its
    property table, scene files and metrics included."""
    assert module in set(_modules())
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in set(_port_files())


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(_modules())!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
