"""``python -m syzygy_tpu_torch.bench`` against the repository's ``bench.py``.

The scenes and the packed rows of every timed frame are held bitwise to
the ones ``bench.py`` builds with the JAX package's host code (its
``_flagship_scene`` itself; the dense field and the chess flagship as
``bench.py:226-273`` build them). ``measure_scene`` runs on the CPU at a
toy size (only its control flow: a CPU time is no device number), and
``main`` without a GPU must print ``value: null`` and fail.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import bench as reference_bench
from test_torch_common import to_numpy_dict

TICKS = 6


def _reference_rows(scene, aspect: float, frames: int):
    """``bench.py:111-122``'s loop: the first row, then a tick of 1/60 s
    before every further row."""
    from syzygy_tpu.scene import flatten_frame_params, frame_param_spec, pack_frame_params

    params0 = pack_frame_params(scene, aspect)
    spec = frame_param_spec(params0)
    buf = np.empty(spec.total, np.float32)
    rows = [np.array(flatten_frame_params(params0, spec, buf))]
    for _ in range(frames):
        scene.tick(1.0 / 60.0)
        rows.append(np.array(flatten_frame_params(pack_frame_params(scene, aspect), spec, buf)))
    return spec, np.stack(rows)


def _reference_camera(scene, eye, target):
    from syzygy_tpu.math.geometry import eulers_from_forward

    eye = np.array(eye, np.float32)
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(np.asarray(eulers_from_forward(np.array(target, np.float32) - eye)))


def _reference_dense():
    """``bench.py:226-253``."""
    from syzygy_tpu.assets import TextureLibrary, register_default_textures, sphere_mesh
    from syzygy_tpu.scene import Scene, TransformHost

    dense = Scene()
    library = TextureLibrary()
    mesh = sphere_mesh(register_default_textures(library), rings=32, segments=64)
    side = 8
    dense.add_mesh_instance(
        mesh,
        "spheres",
        [
            TransformHost.make((8.0 * (i % side) - 4.0 * side, -6.0, 8.0 * (i // side) - 4.0 * side))
            for i in range(64)
        ],
    )
    dense.tick(0.0)
    _reference_camera(dense, (18.0, -16.0, -22.0), (0.0, -6.0, 0.0))
    return dense, library


def _reference_chess():
    """``bench.py:260-271``."""
    from syzygy_tpu.assets.chess import flagship_scene

    chess, library = flagship_scene()
    chess.tick(0.0)
    _reference_camera(chess, (13.0, -8.0, -14.0), (0.0, -1.0, 0.0))
    return chess, library


def _assert_spec_equal(port, ref):
    assert port.shapes == tuple(tuple(s) for s in ref.shapes)
    assert port.dtypes == tuple(ref.dtypes)
    assert port.offsets == tuple(ref.offsets) and port.total == ref.total


def test_pack_rows_match_reference_animated_sun():
    """Six ticks of the default scene with the sun at 5000x: the rows,
    sun direction included, are bitwise ``bench.py``'s."""
    from syzygy_tpu_torch import bench

    ref_scene, _ = reference_bench._flagship_scene()
    ref_spec, want = _reference_rows(ref_scene, 16.0 / 9.0, TICKS)
    scene, _ = bench.default_scene_animated()
    spec, rows = bench.pack_rows(scene, 16.0 / 9.0, TICKS)
    _assert_spec_equal(spec, ref_spec)
    assert rows.dtype == np.float32 and rows.shape == (TICKS + 1, spec.total)
    np.testing.assert_array_equal(rows, want)
    assert scene.sun_animation.time == ref_scene.sun_animation.time
    # the sun moved: the rows differ where the atmosphere's sun angles sit
    assert not np.array_equal(rows[0], rows[-1])


@pytest.mark.parametrize("which", ["dense", "chess"])
def test_scenes_match_reference(which):
    """The dense field and the chess flagship: every ``pack_geometry``
    array and the first row (the camera) bitwise the reference's."""
    from syzygy_tpu.scene import pack_geometry

    from syzygy_tpu_torch import bench
    from syzygy_tpu_torch.scene.pack import pack_geometry_host

    ref_scene, ref_lib = {"dense": _reference_dense, "chess": _reference_chess}[which]()
    scene, library = {"dense": bench.dense_scene, "chess": bench.chess_scene}[which]()
    want = to_numpy_dict(pack_geometry(ref_scene, ref_lib, quad_pack=False, joint_pack=False))
    got = pack_geometry_host(scene, library)
    assert int(got["tri_valid"].sum()) == {"dense": 253_952, "chess": 14_316}[which]
    for name, array in got.items():
        assert array.dtype == want[name].dtype, name
        np.testing.assert_array_equal(array, want[name], err_msg=name)
    ref_spec, ref_rows = _reference_rows(ref_scene, 16.0 / 9.0, 0)
    spec, rows = bench.pack_rows(scene, 16.0 / 9.0, 0)
    _assert_spec_equal(spec, ref_spec)
    np.testing.assert_array_equal(rows, ref_rows)


def test_measure_scene_on_cpu():
    """The default animated scene at 64x32 (a 64x16 transmittance LUT keeps
    a CPU frame under a second), 3 timed frames in groups of 2: two finite
    groups ([1, 2] and [3]); the last frame is bitwise a direct
    ``render_frame_packed`` of row 3; no device number on the CPU."""
    from syzygy_tpu_torch import bench
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame_packed
    from syzygy_tpu_torch.scene.pack import pack_geometry, scene_uses_metallic

    config = RenderConfig(
        width=64, height=32, shadow_dim=256, skyview_width=128, skyview_height=64,
        transmittance_width=64, transmittance_height=16,
    )
    scene, library = bench.default_scene_animated()
    timing = bench.measure_scene(scene, library, config, "cpu", frames=3, group=2)
    assert timing.device == "cpu" and timing.peak_bytes is None
    assert len(timing.group_ms) == 2 and all(np.isfinite(t) and t > 0 for t in timing.group_ms)
    assert timing.ms == pytest.approx(np.median(timing.group_ms))
    assert timing.launches_per_frame == {"visibility": 0.0, "depth": 0.0, "visibility_full": 0.0, "depth_full": 0.0}  # no kernel on the CPU
    assert timing.graph_pool_bytes is None and timing.capture_s > 0 and len(timing.issue_ms) == 2
    assert tuple(timing.last_frame.shape) == (32, 64, 3)

    fresh, _ = bench.default_scene_animated()
    spec, rows = bench.pack_rows(fresh, 2.0, 3)
    assert spec == timing.spec
    np.testing.assert_array_equal(rows[3], timing.last_row)
    direct_config = dataclasses.replace(config, metallic_reflection=scene_uses_metallic(scene, library))
    direct = render_frame_packed(pack_geometry(scene, library, "cpu"), rows[3], spec, direct_config)
    assert torch.equal(direct, timing.last_frame)
    # the stacked upload's rows render as the host rows do
    assert torch.equal(
        render_frame_packed(pack_geometry(scene, library, "cpu"), torch.from_numpy(rows[3]), spec, direct_config),
        direct,
    )


def test_main_without_gpu(monkeypatch, capsys):
    """No silent CPU run: ``bench.py``'s keys, ``value`` null, an error,
    exit code 1."""
    from syzygy_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "error"} <= set(result)
    assert result["metric"] == "ms/frame, 1920x1080 full deferred+atmosphere frame"
    assert result["value"] is None and result["vs_baseline"] is None and result["unit"] == "ms"
    assert "extra" not in result
