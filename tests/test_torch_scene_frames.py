"""Frames of the scene API rendered by both packages: a second active
camera and a per-surface material override (the set-ups of
``tests/test_scene.py:25`` and ``:52``), each built with each package's
own host code from the same numbers.

128x64 frames, a 128^2 shadow map, a 64x16 sky-view and transmittance LUT.
Tolerances: the visibility ids of the geometry stage exact (the reference
packed with ``quad_pack=False, joint_pack=False``, the order the port
packs in); the frame RMSE <= 1e-3 and max abs <= 2e-2, the reference's
own parity class (``tests/test_torch_frame.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import syzygy_tpu_torch  # noqa: F401  (precision pins)

torch.set_num_threads(2)

SMALL = dict(width=128, height=64, shadow_dim=128, skyview_width=64, skyview_height=16,
             transmittance_width=64, transmittance_height=16)
SECOND_EYE = (30.0, -5.0, 0.0)
TARGET = (0.0, -6.0, 0.0)
FRAME_RMSE = 1e-3
FRAME_MAX = 2e-2


def _build(case, default_scene, camera_cls, eulers_from_forward, material_cls):
    """``case`` on one package's default scene: ``camera`` makes a second
    camera the active one, ``override`` paints the first cube's surface
    red through ``set_material_override``."""
    scene, library = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    eye = np.asarray(SECOND_EYE, np.float32)
    eulers = tuple(np.asarray(eulers_from_forward(np.asarray(TARGET, np.float32) - eye)))
    scene.camera.position, scene.camera.euler_angles = (18.0, -16.0, -22.0), eulers
    if case == "camera":
        scene.camera_index = scene.add_camera(camera_cls(position=tuple(eye), euler_angles=eulers))
    else:
        red = np.zeros((8, 8, 4), np.float32)
        red[..., 0], red[..., 3] = 0.8, 1.0
        red_id = library.register("override_red", red)
        material = scene.geometry[0].mesh.surfaces[0].material
        scene.geometry[0].set_material_override(
            0, material_cls(color=red_id, normal=material.normal, orm=material.orm)
        )
    return scene, library


@functools.lru_cache(maxsize=None)
def reference(case):
    """(vis ids, frame) of the JAX package."""
    from syzygy_tpu.assets import MaterialData
    from syzygy_tpu.math.geometry import eulers_from_forward
    from syzygy_tpu.renderer import RenderConfig, render_frame
    from syzygy_tpu.renderer.frame import _stage_geometry
    from syzygy_tpu.scene import default_scene, pack_frame_params, pack_geometry
    from syzygy_tpu.scene.camera import Camera

    scene, library = _build(case, default_scene, Camera, eulers_from_forward, MaterialData)
    config = RenderConfig(**SMALL)
    geometry = pack_geometry(scene, library, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, SMALL["width"] / SMALL["height"])
    vis = _stage_geometry(geometry, params, config)[1]
    return np.asarray(vis.tri), np.asarray(render_frame(geometry, params, config))


@functools.lru_cache(maxsize=None)
def port(case):
    from syzygy_tpu_torch.assets.types import MaterialData
    from syzygy_tpu_torch.math.geometry import eulers_from_forward
    from syzygy_tpu_torch.renderer.frame import RenderConfig, _stage_geometry, render_frame
    from syzygy_tpu_torch.scene.camera import Camera
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from syzygy_tpu_torch.scene.scene import default_scene

    def eulers(forward):
        return eulers_from_forward(torch.from_numpy(forward)).numpy()

    scene, library = _build(case, default_scene, Camera, eulers, MaterialData)
    config = RenderConfig(**SMALL)
    geometry = pack_geometry(scene, library, "cpu")
    params = upload_frame_params(pack_frame_params(scene, SMALL["width"] / SMALL["height"]), "cpu")
    vis = _stage_geometry(geometry, params, config)[1]
    return vis.tri.numpy(), render_frame(geometry, params, config).numpy()


@pytest.mark.parametrize("case", ["camera", "override"])
def test_visibility_ids_exact(case):
    """The camera raster of the active camera covers the same triangles
    at every pixel as the reference's."""
    (port_ids, _), (ref_ids, _) = port(case), reference(case)
    h, w = SMALL["height"], SMALL["width"]
    np.testing.assert_array_equal(port_ids[:h, :w], ref_ids[:h, :w])
    assert (port_ids[:h, :w] >= 0).mean() > 0.1


@pytest.mark.parametrize("case", ["camera", "override"])
def test_frame_matches_reference(case):
    (_, frame), (_, ref_frame) = port(case), reference(case)
    assert frame.shape == ref_frame.shape == (SMALL["height"], SMALL["width"], 3)
    err = frame.astype(np.float64) - ref_frame
    assert np.sqrt(np.mean(err**2)) <= FRAME_RMSE and np.abs(err).max() <= FRAME_MAX


def test_cases_change_the_frame():
    """Each case moves the frame: the second camera sees the scene from
    elsewhere, the override paints the cube's face red."""
    from syzygy_tpu_torch.assets.types import MaterialData
    from syzygy_tpu_torch.math.geometry import eulers_from_forward
    from syzygy_tpu_torch.scene.pack import pack_geometry_host
    from syzygy_tpu_torch.scene.camera import Camera
    from syzygy_tpu_torch.scene.scene import default_scene

    camera, override = port("camera")[1], port("override")[1]
    assert np.abs(camera - override).max() > 0.1
    scene, library = _build("override", default_scene, Camera,
                            lambda f: eulers_from_forward(torch.from_numpy(f)).numpy(), MaterialData)
    materials = pack_geometry_host(scene, library)["materials"]
    assert library.lookup("override_red") in set(materials[:, 0].tolist())
