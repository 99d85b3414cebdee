"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from conftest import CELLS, ROOT

from frame_bench.run import FORBIDDEN, forbidden_modules

BENCH = os.path.join(ROOT, "frame_bench")


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for dirpath, _, files in os.walk(top):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        for name in _imports(path):
            assert name.split(".")[0] in {
                "frame_bench", "__future__", "numpy", "torch", "typing", "dataclasses", "math",
                "enum", "struct", "zlib", "json", "base64", "logging", "os", "collections",
                "functools", "ctypes",
            }, (path, name)
            assert not name.startswith("frame_bench.") or name.startswith("frame_bench.reference"), (path, name)


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "syzygy_tpu_torch_lookalike", sys)
    assert "syzygy_tpu_torch_lookalike" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "syzygy_tpu.kernels", sys)
    assert forbidden_modules() == ["syzygy_tpu.kernels"]


def test_a_run_loads_no_jax():
    script = f"""
import json, sys, time, torch
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})
torch.set_num_threads(4)
from conftest import small_cell
from frame_bench.run import result_line
result = result_line(small_cell({CELLS[0]!r}), 7, 0.5, False, torch.device("cpu"), time.perf_counter())
print(json.dumps([result is not None, sorted({{m.split(".")[0] for m in sys.modules}})]))
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ok
    assert "syzygy_tpu_torch" in loaded  # the port ran
    assert not set(loaded) & set(FORBIDDEN)
