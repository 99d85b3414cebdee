"""The scenes of the repository's ``bench.py`` on the port's host code.

``bench.py`` times the JAX package on a TPU; the port is measured by
``frame_bench/``. This module keeps ``bench.py``'s scenes (the editor's
default scene with the sun animated, the dense sphere field, the chess
flagship), each with its camera, the frames' packed params rows
(:func:`pack_rows`) and a frame with every light slot live
(:func:`all_slots_live`), which ``chip_smoke.py`` and the tests render.
"""

from __future__ import annotations

import numpy as np
import torch

DT = 1.0 / 60.0  # scene time between two frames
SCENE_EYE, SCENE_TARGET = (18.0, -16.0, -22.0), (0.0, -6.0, 0.0)  # bench.py:64-65, :244-245
CHESS_EYE, CHESS_TARGET = (13.0, -8.0, -14.0), (0.0, -1.0, 0.0)  # bench.py:266-267


def look_at(scene, eye, target) -> None:
    """Put ``scene``'s camera at ``eye``, facing ``target``."""
    from syzygy_tpu_torch.math.geometry import eulers_from_forward

    eye = torch.tensor(eye, dtype=torch.float32)
    forward = torch.tensor(target, dtype=torch.float32) - eye
    scene.camera.position = tuple(eye.tolist())
    scene.camera.euler_angles = tuple(eulers_from_forward(forward).tolist())


def default_scene_animated():
    """The editor's default scene with the sun animated
    (``bench.py:54-71``): time of day 0.35, 5000x speed."""
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, library = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = False
    scene.sun_animation.speed = 5000.0
    scene.tick(0.0)
    look_at(scene, SCENE_EYE, SCENE_TARGET)
    return scene, library


def dense_scene():
    """64 UV spheres (32 rings, 64 segments) on an 8x8 grid, 253,952
    triangles (``bench.py:226-256``)."""
    from syzygy_tpu_torch.scene.scene import dense_sphere_field

    scene, library = dense_sphere_field()
    look_at(scene, SCENE_EYE, SCENE_TARGET)
    return scene, library


def chess_scene():
    """The chess flagship through the glTF path, 14,316 triangles
    (``bench.py:260-273``)."""
    from syzygy_tpu_torch.assets.chess import flagship_scene

    scene, library = flagship_scene()
    scene.tick(0.0)
    look_at(scene, CHESS_EYE, CHESS_TARGET)
    return scene, library


def all_slots_live(state, maps):
    """Every light slot of a frame of :func:`default_scene_animated` live:
    both directional lights (strengths 2 and 1) and 16 spots, the scene's
    spot moved and turned 16 seeded ways with strengths 0.5-3, each spot
    slot given one of the first three slots' maps. ``state`` and ``maps``
    are the frame's state and shadow maps; returns (lights, maps), the
    lights keyed as ``deferred_lighting`` takes them."""
    d, s = state.directional_lights, state.spot_lights
    dev = maps.device
    shift = torch.from_numpy(np.random.default_rng(16).uniform(-3.0, 3.0, (16, 3)).astype(np.float32)).to(dev)
    spots = type(s)(*[x[:1].expand(16, *x.shape[1:]).clone() for x in s])
    spots = spots._replace(
        position=torch.cat([spots.position[:, :3] + shift, spots.position[:, 3:]], dim=1),
        forward=torch.cat([spots.forward[:, :3] + 0.1 * shift, spots.forward[:, 3:]], dim=1),
        strength=torch.linspace(0.5, 3.0, 16, device=dev),
    )
    mixed = maps.clone()
    for j in range(16):
        mixed[2 + j] = maps[j % 3]

    def i32(n):
        return torch.tensor(n, dtype=torch.int32, device=dev)

    lights = dict(
        directional=d._replace(strength=torch.tensor([2.0, 1.0], device=dev)), directional_count=i32(2),
        directional_skip=i32(0), spots=spots, spot_count=i32(16),
    )
    return lights, mixed


def pack_rows(scene, aspect: float, frames: int):
    """(spec, rows): ``frames + 1`` flattened FrameParams rows, (frames + 1,
    spec.total) f32, the scene ticked by 1/60 s between two rows
    (``bench.py:111-122``). The scene is left at its last row's state."""
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params

    params = pack_frame_params(scene, aspect)
    spec = frame_param_spec(params)
    rows = np.empty((frames + 1, spec.total), np.float32)
    flatten_frame_params(params, spec, rows[0])
    for i in range(1, frames + 1):
        scene.tick(DT)
        flatten_frame_params(pack_frame_params(scene, aspect), spec, rows[i])
    return spec, rows
