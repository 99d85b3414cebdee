"""The port's C++ host core (``syzygy_tpu_torch/native.py``) vs the reference's.

The port builds its own copy of ``szg_native.cpp`` with the reference
Makefile's flags; the reference loads its committed
``native/build/libszg_native.so``. Tolerances: every entry point bitwise
against the reference's library on seeded inputs; ``Scene.shadow_bounds``
and ``pack_frame_params`` bitwise against the reference's on seeded
rotated casters, with the C++ path on both sides and with it patched off
on both sides; the port's own C++ path against its numpy path at the
reference's 1e-4 (``tests/test_fallbacks.py:15-21``); the ports of
``tests/test_native.py`` at that file's tolerances.
"""

from __future__ import annotations

import functools
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (thread count, precision pins)

from syzygy_tpu import native as ref_native
from syzygy_tpu_torch import native
from syzygy_tpu_torch.scene.scene import TransformHost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = 40


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert native.available(), "the port's C++ core did not build"
    assert ref_native.available(), "the reference's C++ core did not load"


# --- the ports of tests/test_native.py -------------------------------------


def test_trs_matrices_match_python():
    rng = np.random.default_rng(3)
    n = 64
    t = rng.normal(size=(n, 3)).astype(np.float32)
    e = rng.uniform(-math.pi, math.pi, (n, 3)).astype(np.float32)
    s = rng.uniform(0.5, 3.0, (n, 3)).astype(np.float32)
    out = native.trs_to_matrices(t, e, s)
    for i in range(0, n, 7):
        ref = TransformHost.make(t[i], e[i], s[i]).to_matrix()
        np.testing.assert_allclose(out[i], ref, atol=1e-6)


def test_shadow_bounds_match_python():
    rng = np.random.default_rng(4)
    n = 10
    t = rng.normal(size=(n, 3)).astype(np.float32) * 5
    e = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
    mats = native.trs_to_matrices(t, e, s)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    casts = np.ones(n, np.uint8)
    casts[3] = 0  # one non-caster
    found, mn, mx = native.shadow_bounds(casts, np.tile(corners[None], (n, 1, 1)), mats)
    assert found
    ref_mn, ref_mx = np.full(3, np.inf), np.full(3, -np.inf)
    ch = np.concatenate([corners, np.ones((8, 1), np.float32)], 1)
    for i in range(n):
        if casts[i]:
            world = (mats[i] @ ch.T).T[:, :3]
            ref_mn, ref_mx = np.minimum(ref_mn, world.min(0)), np.maximum(ref_mx, world.max(0))
    np.testing.assert_allclose(mn, ref_mn, atol=1e-5)
    np.testing.assert_allclose(mx, ref_mx, atol=1e-5)


def test_shadow_bounds_no_casters():
    found, mn, mx = native.shadow_bounds(
        np.zeros(2, np.uint8), np.zeros((2, 8, 3), np.float32), np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    )
    assert not found
    np.testing.assert_array_equal(mn, 0)
    np.testing.assert_array_equal(mx, 0)


def test_bin_triangles_exact():
    # one triangle in tile (0, 0), one across tiles 0 and 1, one invalid
    bboxes = np.array([[5, 5, 20, 20], [120, 5, 140, 20], [0, 0, 500, 500]], np.float32)
    valid = np.array([1, 1, 0], np.uint8)
    counts, indices, dropped = native.bin_triangles(bboxes, valid, tiles_x=2, tiles_y=1, tile_w=128, tile_h=64, capacity=4)
    assert dropped == 0
    assert counts[0, 0] == 2 and counts[0, 1] == 1
    assert set(indices[0, 0, :2].tolist()) == {0, 1}
    assert indices[0, 1, 0] == 1


def test_bin_triangles_overflow_reported():
    bboxes = np.tile(np.array([[1, 1, 5, 5]], np.float32), (10, 1))
    counts, _, dropped = native.bin_triangles(
        bboxes, np.ones(10, np.uint8), tiles_x=1, tiles_y=1, tile_w=64, tile_h=64, capacity=4
    )
    assert counts[0, 0] == 4
    assert dropped == 6


def test_tick_animations():
    kinds = np.array([1, 2, 0], np.int32)
    originals = np.array([[1, 0, 2], [0, 0, 0], [5, 5, 5]], np.float32)
    translations = originals.copy()
    eulers = np.zeros((3, 3), np.float32)
    native.tick_animations(kinds, originals, translations, eulers, 0.25, 0.1)
    expected_y = math.sin(0.25 + (1 + 10 + 2 + 10) / 3.1415)
    assert abs(translations[0, 1] - expected_y) < 1e-6
    assert abs(eulers[1, 2] - 0.1) < 1e-6
    np.testing.assert_array_equal(translations[2], [5, 5, 5])


# --- the port of tests/test_fallbacks.py:15-21 -----------------------------


def test_shadow_bounds_python_fallback(monkeypatch):
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, _ = default_scene()
    calls = native.CALLS.shadow_bounds
    with_native = scene.shadow_bounds()
    assert native.CALLS.shadow_bounds == calls + 1  # the C++ path ran
    monkeypatch.setattr(native, "available", lambda: False)
    without = scene.shadow_bounds()
    assert native.CALLS.shadow_bounds == calls + 1
    np.testing.assert_allclose(with_native[0], without[0], atol=1e-4)
    np.testing.assert_allclose(with_native[1], without[1], atol=1e-4)


# --- the port's library against the reference's, bitwise ------------------


def _trs(rng, n):
    return (
        (rng.normal(size=(n, 3)) * 20).astype(np.float32),
        rng.uniform(-math.pi, math.pi, (n, 3)).astype(np.float32),
        rng.uniform(0.1, 8.0, (n, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("seed", range(4))
def test_trs_to_matrices_bitwise_reference(seed):
    trs = _trs(np.random.default_rng(seed), 257)
    np.testing.assert_array_equal(native.trs_to_matrices(*trs), ref_native.trs_to_matrices(*trs))


@pytest.mark.parametrize("seed", range(4))
def test_shadow_bounds_bitwise_reference(seed):
    rng = np.random.default_rng(100 + seed)
    n = 97
    mats = ref_native.trs_to_matrices(*_trs(rng, n))
    corners = (rng.normal(size=(n, 8, 3)) * 3).astype(np.float32)
    casts = (rng.uniform(size=n) < 0.8).astype(np.uint8)
    got, want = native.shadow_bounds(casts, corners, mats), ref_native.shadow_bounds(casts, corners, mats)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("seed", range(4))
def test_bin_triangles_bitwise_reference(seed):
    rng = np.random.default_rng(200 + seed)
    n = 500
    lo = rng.uniform(-40, 600, size=(n, 2)).astype(np.float32)
    bboxes = np.concatenate([lo, lo + rng.uniform(0, 150, size=(n, 2)).astype(np.float32)], axis=1)
    valid = (rng.uniform(size=n) < 0.9).astype(np.uint8)
    args = (bboxes, valid, 5, 9, 128, 64, 24)
    got, want = native.bin_triangles(*args), ref_native.bin_triangles(*args)
    assert got[2] == want[2] and got[2] > 0  # some tiles overflow
    np.testing.assert_array_equal(got[0], want[0])
    for ty in range(9):
        for tx in range(5):  # entries past a tile's count are unwritten memory
            c = got[0][ty, tx]
            np.testing.assert_array_equal(got[1][ty, tx, :c], want[1][ty, tx, :c])


@pytest.mark.parametrize("seed", range(4))
def test_tick_animations_bitwise_reference(seed):
    rng = np.random.default_rng(300 + seed)
    n = 64
    kinds = rng.integers(0, 3, size=n).astype(np.int32)
    originals, eulers, _ = _trs(rng, n)
    out = []
    for lib in (native, ref_native):
        t, e = originals.copy(), eulers.copy()
        for step in range(5):
            lib.tick_animations(kinds, originals, t, e, 0.37 * step, 1.0 / 60.0)
        out.append((t, e))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_library_is_the_ports_own():
    """Built from the port's source into the port's build directory, with
    the reference Makefile's flags (fused multiply-adds left on)."""
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.exists(path)
    assert native.SOURCE.startswith(os.path.join(ROOT, "syzygy_tpu_torch", "csrc"))
    with open(os.path.join(ROOT, "native", "Makefile")) as f:
        makefile = f.read()
    assert "CXXFLAGS ?= " + " ".join(native.CXXFLAGS[:-1]) in makefile
    assert "-ffp-contract" not in " ".join(native.CXXFLAGS)


def test_import_builds_and_loads_nothing():
    code = (
        "import subprocess, sys\n"
        "runs = []\n"
        "subprocess.run = subprocess.Popen = lambda *a, **k: runs.append(a)\n"
        "import syzygy_tpu_torch.native as n\n"
        "assert not runs and n._lib is None and not n._tried, (runs, n._lib, n._tried)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --- Scene.shadow_bounds and pack_frame_params, rotated casters ------------


@functools.lru_cache(maxsize=None)
def _scenes(which):
    """(reference scene, port scene), this module's own (their eulers are
    overwritten per seed)."""
    if which == "default":
        from syzygy_tpu.scene import default_scene as reference
        from syzygy_tpu_torch.scene.scene import default_scene as port
    elif which == "flagship":
        from syzygy_tpu.assets.chess import flagship_scene as reference
        from syzygy_tpu_torch.assets.chess import flagship_scene as port
    else:
        from syzygy_tpu.app.scenes import builtin_scene
        from syzygy_tpu_torch.app.scenes import builtin_scene as port_builtin

        return builtin_scene(which)[0], port_builtin(which)[0]
    return reference()[0], port()[0]


def _rotate(scenes, seed):
    """A seeded euler triple on every transform of both scenes."""
    rng = np.random.default_rng(seed)
    ref, port = scenes
    for ri, pi in zip(ref.geometry, port.geometry, strict=True):
        for rt, pt in zip(ri.transforms, pi.transforms, strict=True):
            e = rng.uniform(-math.pi, math.pi, 3).astype(np.float32)
            rt.euler_angles[:] = e
            pt.euler_angles[:] = e


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """The C++ path on both sides, or ``available`` patched off on both."""
    if request.param == "numpy":
        monkeypatch.setattr(ref_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("which", ["default", "flagship"])
def test_scene_shadow_bounds_bitwise_reference(which, path):
    scenes = _scenes(which)
    calls = native.CALLS.shadow_bounds
    for seed in range(SEEDS):
        _rotate(scenes, seed)
        want, got = scenes[0].shadow_bounds(), scenes[1].shadow_bounds()
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"seed {seed} min")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"seed {seed} max")
    assert native.CALLS.shadow_bounds - calls == (SEEDS if path == "native" else 0)


def test_pack_frame_params_bitwise_rotated_sphere(path):
    """The sphere scene with a seeded euler per instance, 20 seeds: every
    leaf of FrameParams bitwise, the shadow bounds included."""
    from syzygy_tpu.scene import pack_frame_params as reference_pack

    from syzygy_tpu_torch.scene.pack import pack_frame_params

    from test_torch_common import to_numpy_dict

    scenes = _scenes("sphere")
    for seed in range(20):
        _rotate(scenes, 1000 + seed)
        want = to_numpy_dict(reference_pack(scenes[0], 16 / 9))
        got = to_numpy_dict(pack_frame_params(scenes[1], 16 / 9))
        assert set(got) == set(want)
        for name in got:
            for key, value in (got[name].items() if isinstance(got[name], dict) else [("", got[name])]):
                expect = want[name][key] if key else want[name]
                np.testing.assert_array_equal(np.asarray(value), expect, err_msg=f"seed {seed} {name}.{key}")
