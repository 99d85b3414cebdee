"""Build the port's CUDA sources (``csrc/*.cu``) and bind them with ctypes.

Each source compiles with ``nvcc`` for sm_90a into a shared library with a
plain C interface, ``_build/libsyzygy_<name>_<hash>.so``, keyed by a hash
of the source, the headers of ``csrc/`` and its flags, at first use (so a
checkout builds what it runs, nothing else). ptxas's register/shared-memory report of each build
is kept beside the library as ``.so.log``. :func:`build` starts one
``nvcc`` per missing source, all at once, and waits for them together.
:func:`load` binds each entry point's ctypes signature once, when it
first loads a library, so a launch binds nothing.

:func:`launch` is every kernel's launch: it passes the device index and
the current raw stream, raises when the launch fails, and counts the
launch by kind into :data:`LAUNCHES`, or, while the calling thread
captures a CUDA graph inside :func:`capture_record`, into that capture's
record, which each replay of the graph adds to :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")

# source name -> its extra nvcc flags
SOURCES = {
    # the raster places its fused multiply-adds by hand (__fmaf_rn) and
    # must contract nothing else
    "raster": ("--fmad=false",),
    # the lighting rounds every operation as the plain version's PyTorch
    # operations do (__fmul_rn/__fadd_rn) and must contract nothing
    "lighting": ("--fmad=false",),
    # the in-scattering integral likewise
    "scattering": ("--fmad=false",),
    "gather": (),
    "stamp": (),
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source name -> {entry point: (argtypes, restype)}
ENTRY_POINTS = {
    # coeffs, boxes | n_slots | slots, offsets, overflow | full, tiles_y,
    # tiles_x, oy, ox, depth_only | depth, tri, b0, b1 | device, stream
    "raster": {"szg_raster": ([_P, _P, _I] + [_P] * 3 + [_I] * 6 + [_P] * 4 + [_I, _P], _I)},
    # diffuse, specular, normal, position, orm, camera, table | shadowed,
    # unshadowed, spots | n_dir, n_spot, shadowless | maps | size, f16 |
    # codes, lo, step | n_w | sun_shadow, out, slots | n | device, stream
    "lighting": {
        "szg_lighting": ([_P] * 7 + [_P] * 3 + [_I] * 3 + [_P] + [_I] * 2 + [_P] * 3 + [_I] + [_P] * 3 + [_LL, _I, _P], _I),
    },
    # origin, origin_stride, direction, distance, lut, lut_h, lut_w, table,
    # out0, out1, n, components, device, stream
    "scattering": {"szg_scattering": ([_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _LL, _I, _I, _P], _I)},
    # table, table_n, idx, out, n, device, stream
    "gather": {"szg_lane_gather": ([_P, _LL, _P, _P, _LL, _I, _P], _I)},
    # ring, seq, rows, stride, mark, last, device, stream | stream, nodes
    "stamp": {"szg_stamp": ([_P, _P] + [_I] * 5 + [_P], _I), "szg_capture_nodes": ([_P, _P], _I)},
}
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_SOURCE_OF = {entry: name for name, entries in ENTRY_POINTS.items() for entry in entries}

_loaded: dict[str, ctypes.CDLL] = {}
# kernel launches by kind: the raster's visibility, depth, visibility_full
# and depth_full, lighting, scattering (and the scattering_rays they
# integrate), lane_gather and stamp
LAUNCHES: collections.Counter = collections.Counter()
_capturing = threading.local()


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


def call(entry: str, *args) -> None:
    """Call entry point ``entry`` of its source's library; raises when it
    returns a CUDA error."""
    err = getattr(load(_SOURCE_OF[entry]), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def launch(entry: str, device: torch.device, *args, counts: dict) -> None:
    """Launch ``entry`` with ``args``, then ``device``'s index and its
    current raw stream, without waiting; ``counts`` (kind -> number) go to
    :data:`LAUNCHES`, or to the open :func:`capture_record` while the
    stream captures a graph (a launch captured outside one counts
    nowhere: it is captured, not launched)."""
    call(entry, *args, device.index, torch._C._cuda_getCurrentRawStream(device.index))
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES.update(counts)
    elif getattr(_capturing, "record", None) is not None:
        _capturing.record.update(counts)


@contextlib.contextmanager
def capture_record():
    """The launches that this thread captures into a CUDA graph inside, by
    kind (a Counter): what each replay of the graph launches."""
    if getattr(_capturing, "record", None) is not None:
        raise RuntimeError("a capture is already being recorded on this thread")
    _capturing.record = collections.Counter()
    try:
        yield _capturing.record
    finally:
        _capturing.record = None
