"""ctypes bindings for the C++ host core (``csrc/szg_native.cpp``).

Port of ``syzygy_tpu/native.py``: the same entry points, signatures and
fallback rule. The library is the port's own copy of the reference's
source, built with ``g++`` at first use (never at import) into
``_build/libszg_native_<hash>.so``, the hash covering the source, the
flags and what ``-march=native`` means on this host, so a checkout copied
to another machine builds its own. ``load`` returns None when there is no
compiler or the build fails; callers then take their numpy path, as the
reference's do.

The flags are ``native/Makefile``'s. At ``-O3 -march=native`` g++
contracts ``a * b + c`` into fused multiply-adds, and the reference's
results carry those roundings: contraction must stay on for the port's
numbers to be the reference's bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

log = logging.getLogger("syzygy")

_PACKAGE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PACKAGE, "csrc", "szg_native.cpp")
BUILD_DIR = os.path.join(_PACKAGE, "_build")
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False


class CallCounts:
    """Calls into the library per entry point, counted by each wrapper
    where it calls the C function and nowhere else."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.trs_to_matrices = 0
        self.shadow_bounds = 0
        self.bin_triangles = 0
        self.tick_animations = 0


CALLS = CallCounts()


def _target() -> str:
    """The compiler's version and its expansion of ``-march=native`` on
    this host (the ``cc1plus`` line of a verbose preprocess)."""
    out = subprocess.run(
        [CXX, *CXXFLAGS[:2], "-E", "-v", "-x", "c++", os.devnull, "-o", os.devnull],
        capture_output=True, text=True, check=True,
    ).stderr
    return "\n".join(line for line in out.splitlines() if "cc1plus" in line or line.startswith("gcc version"))


def library_path() -> str:
    """Where the library for the current source, flags and host lives."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXXFLAGS).encode())
    digest.update(_target().encode())
    return os.path.join(BUILD_DIR, f"libszg_native_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless its library exists; returns its path.
    Concurrent builds each write a temporary file and move it into
    place, so a reader never sees a partial library."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([CXX, *CXXFLAGS, "-o", tmp, SOURCE], check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log.debug("native build failed: %s", getattr(e, "stderr", None) or e)
        return None
    except OSError as e:
        log.debug("native load failed: %s", e)
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.szg_tick_animations.argtypes = [
        ctypes.c_int64, i32p, f32p, f32p, f32p, ctypes.c_double, ctypes.c_double,
    ]
    lib.szg_tick_animations.restype = None
    lib.szg_trs_to_matrices.argtypes = [ctypes.c_int64, f32p, f32p, f32p, f32p]
    lib.szg_trs_to_matrices.restype = None
    lib.szg_shadow_bounds.argtypes = [ctypes.c_int64, u8p, f32p, f32p, f32p, f32p]
    lib.szg_shadow_bounds.restype = ctypes.c_int32
    lib.szg_bin_triangles.argtypes = [
        ctypes.c_int64, f32p, u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p,
    ]
    lib.szg_bin_triangles.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def trs_to_matrices(translations, eulers, scales) -> np.ndarray:
    """(n,3)x3 float32 -> (n,4,4) model matrices (T @ R @ S)."""
    lib = _require()
    t = np.ascontiguousarray(translations, np.float32)
    e = np.ascontiguousarray(eulers, np.float32)
    s = np.ascontiguousarray(scales, np.float32)
    n = t.shape[0]
    if e.shape != (n, 3) or s.shape != (n, 3) or t.shape != (n, 3):
        raise ValueError(f"trs_to_matrices needs three (n, 3) arrays, got {t.shape}, {e.shape}, {s.shape}")
    out = np.empty((n, 16), np.float32)
    lib.szg_trs_to_matrices(n, t, e, s, out)
    CALLS.trs_to_matrices += 1
    return out.reshape(n, 4, 4)


def shadow_bounds(casts, corners, matrices):
    """Transformed-corner AABB (scene.cpp:95-148). Returns (found, min, max)."""
    lib = _require()
    casts = np.ascontiguousarray(casts, np.uint8)
    corners = np.ascontiguousarray(corners, np.float32)
    matrices = np.ascontiguousarray(np.reshape(matrices, (-1, 16)), np.float32)
    n = casts.shape[0]
    if corners.shape != (n, 8, 3) or matrices.shape != (n, 16):
        raise ValueError(f"shadow_bounds needs (n, 8, 3) corners and n matrices, got {corners.shape}, {matrices.shape}")
    out_min = np.empty(3, np.float32)
    out_max = np.empty(3, np.float32)
    found = lib.szg_shadow_bounds(n, casts, corners, matrices, out_min, out_max)
    CALLS.shadow_bounds += 1
    return bool(found), out_min, out_max


def bin_triangles(bboxes, valid, tiles_x, tiles_y, tile_w, tile_h, capacity):
    """Exact per-tile triangle lists. Returns (counts, indices, dropped)."""
    lib = _require()
    bboxes = np.ascontiguousarray(bboxes, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    if bboxes.shape != (valid.shape[0], 4):
        raise ValueError(f"bin_triangles needs (n, 4) boxes for n flags, got {bboxes.shape}, {valid.shape}")
    counts = np.empty(tiles_y * tiles_x, np.int32)
    indices = np.empty(tiles_y * tiles_x * capacity, np.int32)
    dropped = lib.szg_bin_triangles(
        bboxes.shape[0], bboxes, valid,
        tiles_x, tiles_y, tile_w, tile_h, capacity, counts, indices,
    )
    CALLS.bin_triangles += 1
    return (
        counts.reshape(tiles_y, tiles_x),
        indices.reshape(tiles_y, tiles_x, capacity),
        int(dropped),
    )


def tick_animations(kinds, original_translations, translations, eulers,
                    time_elapsed, delta_time) -> None:
    """In-place animation tick (scene.cpp:463-527): ``translations`` and
    ``eulers`` must be C-contiguous (n, 3) float32 arrays."""
    lib = _require()
    kinds = np.ascontiguousarray(kinds, np.int32)
    originals = np.ascontiguousarray(original_translations, np.float32)
    n = kinds.shape[0]
    if originals.shape != (n, 3):
        raise ValueError(f"tick_animations needs (n, 3) original translations, got {originals.shape}")
    for name, arr in (("translations", translations), ("eulers", eulers)):
        if not (isinstance(arr, np.ndarray) and arr.dtype == np.float32 and arr.flags.c_contiguous
                and arr.shape == (n, 3)):
            raise ValueError(f"tick_animations updates {name} in place: it must be a C-contiguous (n, 3) float32 array")
    lib.szg_tick_animations(
        n,
        kinds,
        originals,
        translations,
        eulers,
        float(time_elapsed),
        float(delta_time),
    )
    CALLS.tick_animations += 1
