"""Build the port's CUDA sources (``csrc/*.cu``) and bind them with ctypes.

Each source compiles with ``nvcc`` for sm_90a into a shared library with a
plain C interface, ``_build/libsyzygy_<name>_<hash>.so``, keyed by a hash
of the source, the headers of ``csrc/`` and its flags, at first use (so a
checkout builds what it runs, nothing else). ptxas's register/shared-memory report of each build
is kept beside the library as ``.so.log``. :func:`build` starts one
``nvcc`` per missing source, all at once, and waits for them together.
:func:`load` binds each entry point's ctypes signature once, when it
first loads a library, so a launch binds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")

# source name -> its extra nvcc flags
SOURCES = {
    # the raster places its fused multiply-adds by hand (__fmaf_rn) and
    # must contract nothing else
    "raster": ("--fmad=false",),
    "gather": (),
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source name -> {entry point: (argtypes, restype)}
ENTRY_POINTS = {
    # coeffs, boxes, slots, offsets | tiles_y, tiles_x, oy, ox, depth_only |
    # depth, tri, b0, b1 | device, stream
    "raster": {"szg_raster": ([_P] * 4 + [_I] * 5 + [_P] * 4 + [_I, _P], _I)},
    # table, table_n, idx, out, n, device, stream
    "gather": {"szg_lane_gather": ([_P, _LL, _P, _P, _LL, _I, _P], _I)},
}
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """Where source ``name``'s library lives for its current content."""
    if name not in SOURCES:
        raise KeyError(f"no CUDA source named {name!r}")
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".h"))
    for file in (f"{name}.cu", *headers):  # the source and every header it may include
        with open(os.path.join(CSRC_DIR, file), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_COMMON + SOURCES[name]).encode())
    return os.path.join(BUILD_DIR, f"libsyzygy_{name}_{digest.hexdigest()[:16]}.so")


def build(*names: str) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` each, concurrently. Returns name -> library path."""
    names = names or tuple(SOURCES)
    paths = {name: library_path(name) for name in names}
    missing = [name for name, so_path in paths.items() if not os.path.exists(so_path)]
    compiler = nvcc() if missing else None
    jobs = []
    failures = []
    try:
        for name in missing:
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [compiler, *_COMMON, *SOURCES[name], "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            jobs.append((name, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for name, tmp, proc in jobs:
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on csrc/{name}.cu:\n{stderr}")
                continue
            with open(tmp + ".log", "w") as f:  # ptxas register/smem report
                f.write(stderr)
            os.replace(tmp + ".log", paths[name] + ".log")
            os.replace(tmp, paths[name])
    finally:  # no compiler outlives the call; no partial library stays
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library of source ``name``, built first if needed, its entry
    points' signatures bound."""
    if name not in _loaded:
        lib = ctypes.CDLL(build(name)[name])
        for entry, (argtypes, restype) in ENTRY_POINTS[name].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
        _loaded[name] = lib
    return _loaded[name]


def ptxas_report(name: str) -> str:
    """ptxas's lines for the built library of ``name`` (registers, shared
    memory, spills), one line."""
    with open(library_path(name) + ".log") as f:
        return " | ".join(line.strip() for line in f if line.strip())
