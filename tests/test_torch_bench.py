"""``syzygy_tpu_torch.bench``'s scenes against the repository's ``bench.py``.

The scenes and the packed rows of every frame are held bitwise to the
ones ``bench.py`` builds with the JAX package's host code (its
``_flagship_scene`` itself; the dense field and the chess flagship as
``bench.py:226-273`` build them).
"""

from __future__ import annotations

import numpy as np
import pytest

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
