"""The port's package namespaces against the reference's.

Every name of each reference package's ``__all__`` (read by AST from
``syzygy_tpu/<package>/__init__.py``, so nothing of the reference is
imported) imports from the port's package of the same path, and is the
object of the port module the reference takes it from. Importing
``syzygy_tpu_torch.kernels`` builds and loads no CUDA library. The names
``math/geometry.py`` adds for the namespace hold the reference's values.
"""

from __future__ import annotations

import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (thread count, precision pins)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("scene", "math", "kernels", "assets", "utils", "renderer", "parallel")
COUNTS = {"scene": 41, "math": 20, "kernels": 16, "assets": 9, "utils": 4, "renderer": 3, "parallel": 4}


def reference_names(package: str) -> dict[str, str]:
    """``__all__`` of ``syzygy_tpu/<package>`` -> the module each name is
    imported from there."""
    with open(os.path.join(ROOT, "syzygy_tpu", package, "__init__.py")) as f:
        tree = ast.parse(f.read())
    source, names = {}, None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            source.update({alias.name: node.module for alias in node.names})
        elif isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            names = [elt.value for elt in node.value.elts]
    return {name: source[name] for name in names}


@pytest.mark.parametrize("package", PACKAGES)
def test_reference_all_importable_from_port(package):
    names = reference_names(package)
    assert len(names) == COUNTS[package]
    port = importlib.import_module(f"syzygy_tpu_torch.{package}")
    assert sorted(port.__all__) == sorted(names)
    for name, module in names.items():
        port_module = importlib.import_module(module.replace("syzygy_tpu", "syzygy_tpu_torch", 1))
        assert getattr(port, name) is getattr(port_module, name), name


def test_kernels_import_loads_no_cuda_library():
    code = (
        "import ctypes, sys\n"
        "loaded = []\n"
        "real = ctypes.CDLL.__init__\n"
        "def spy(self, name, *a, **k):\n"
        "    loaded.append(name)\n"
        "    real(self, name, *a, **k)\n"
        "ctypes.CDLL.__init__ = spy\n"
        "import syzygy_tpu_torch.kernels as k\n"
        "from syzygy_tpu_torch.kernels import build\n"
        "bad = [n for n in loaded if n and ('syzygy' in str(n) or 'cuda' in str(n).lower())]\n"
        "assert not bad and not build._loaded, (bad, build._loaded)\n"
        "assert 'rasterize' in k.__all__\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_geometry_names_match_reference():
    """The world axes exactly; ``transform_vk``/``transform_to_matrix`` on
    seeded inputs within 1e-6 of each output's magnitude (the class of
    ``test_torch_pack.py::test_geometry_helpers_match_reference``);
    ``aabb_from_min_max`` bitwise."""
    from syzygy_tpu.math import geometry as ref

    from syzygy_tpu_torch.math import geometry as port

    for name in ("WORLD_FORWARD", "WORLD_RIGHT", "WORLD_UP"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    rng = np.random.default_rng(31)
    pos = rng.normal(size=(8, 3)).astype(np.float32) * 10
    eulers = rng.uniform(-3, 3, size=(8, 3)).astype(np.float32)
    scale = rng.uniform(0.2, 4, size=(8, 3)).astype(np.float32)

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(b).max())))

    close(port.transform_vk(torch.from_numpy(pos), torch.from_numpy(eulers)), ref.transform_vk(pos, eulers))
    close(port.transform_to_matrix(pos, eulers, scale), ref.transform_to_matrix(pos, eulers, scale))
    close(port.transform_to_matrix([1.0, 2.0, 3.0], [0.0, 0.0, np.pi / 2], [2.0, 2.0, 2.0]),
          ref.transform_to_matrix([1.0, 2.0, 3.0], [0.0, 0.0, np.pi / 2], [2.0, 2.0, 2.0]))
    lo, hi = pos[:4], pos[:4] + np.abs(pos[4:])
    box, ref_box = port.aabb_from_min_max(lo, hi), ref.aabb_from_min_max(lo, hi)
    np.testing.assert_array_equal(box.center.numpy(), np.asarray(ref_box.center))
    np.testing.assert_array_equal(box.half_extent.numpy(), np.asarray(ref_box.half_extent))
    np.testing.assert_array_equal(box.collect_vertices().numpy(), np.asarray(ref_box.collect_vertices()))
