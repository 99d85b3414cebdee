"""Fly camera and its packed device form.

Port of ``syzygy_tpu/scene/camera.py`` (``Camera``, ``scene.cpp:739-794``;
``CameraPacked``, ``gputypes.hpp:17-36``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from syzygy_tpu_torch.math.geometry import (
    inverse4,
    matmul4,
    matvec_fma,
    orientate4,
    perspective_vk,
    view_vk,
    world_forward,
)


class CameraPacked(NamedTuple):
    """``CameraPacked`` (``gputypes.hpp:17-36``)."""

    projection: torch.Tensor
    inverse_projection: torch.Tensor
    view: torch.Tensor
    view_inverse_transpose: torch.Tensor
    rotation: torch.Tensor
    proj_view_inverse: torch.Tensor
    forward_world: torch.Tensor
    position: torch.Tensor


def pack_camera(position, euler_angles, fov_degrees, near, far, aspect_ratio) -> CameraPacked:
    """``Camera::toDeviceEquivalent`` (``scene.cpp:739-794``), perspective.
    All arguments are f32 tensors on one device."""
    proj = perspective_vk(fov_degrees, aspect_ratio, near, far)
    view = view_vk(position, euler_angles)
    rotation = orientate4(euler_angles)
    proj_view = matmul4(proj, view)
    forward4 = torch.cat(
        [world_forward(position.device), torch.zeros(1, dtype=torch.float32, device=position.device)]
    )
    return CameraPacked(
        projection=proj,
        inverse_projection=inverse4(proj),
        view=view,
        view_inverse_transpose=inverse4(view).T,
        rotation=rotation,
        proj_view_inverse=inverse4(proj_view),
        forward_world=matvec_fma(rotation, forward4),
        position=torch.cat(
            [position, torch.ones(1, dtype=torch.float32, device=position.device)]
        ),
    )


@dataclasses.dataclass
class Camera:
    """Host camera state; defaults ``Scene::DEFAULT_CAMERA``
    (``scene.cpp:77-83``)."""

    position: tuple = (0.0, -10.0, -13.0)
    euler_angles: tuple = (0.0, 0.0, 0.0)
    fov_degrees: float = 70.0
    near: float = 0.1
    far: float = 10000.0
