"""Fly camera and its packed device form.

Port of ``syzygy_tpu/scene/camera.py`` (``Camera``, ``scene.cpp:739-794``;
``CameraPacked``, ``gputypes.hpp:17-36``; the fly controls of
``Scene::handleInput``, ``scene.cpp:401-458``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from frame_bench.reference.math.geometry import (
    dot3_fma,
    inverse4,
    matmul4,
    matvec_fma,
    orientate4,
    orientate4_host,
    perspective_vk,
    projection_ortho_vk,
    translate,
    view_vk,
    world_forward,
    world_right,
    world_up,
)

F32 = torch.float32


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


def _ortho_projection(fov_degrees, aspect_ratio, near, far) -> torch.Tensor:
    """``Camera::projection``'s orthographic branch (``scene.cpp:776-794``)
    on f32 tensors: a box of half height ``tan(fov / 2)``."""
    height = torch.tan(torch.deg2rad(fov_degrees) / 2.0)
    mn = torch.stack([-aspect_ratio * height, -height, near])
    mx = torch.stack([aspect_ratio * height, height, far])
    return projection_ortho_vk(mn, mx)


def pack_camera(
    position, euler_angles, fov_degrees, near, far, aspect_ratio, orthographic: bool = False
) -> CameraPacked:
    """``Camera::toDeviceEquivalent`` (``scene.cpp:739-794``). All arguments
    but ``orthographic`` (which selects the projection) are f32 tensors on
    one device."""
    if orthographic:
        proj = _ortho_projection(fov_degrees, aspect_ratio, near, far)
    else:
        proj = perspective_vk(fov_degrees, aspect_ratio, near, far)
    view = view_vk(position, euler_angles)
    rotation = orientate4(euler_angles)
    proj_view = matmul4(proj, view)
    forward4 = torch.cat(
        [world_forward(position.device), torch.zeros(1, dtype=F32, device=position.device)]
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
            [position, torch.ones(1, dtype=F32, device=position.device)]
        ),
    )


def _f32(*values, device) -> list[torch.Tensor]:
    return [torch.tensor(np.asarray(v, np.float32), device=device) for v in values]


@dataclasses.dataclass
class Camera:
    """Host camera state; defaults ``Scene::DEFAULT_CAMERA``
    (``scene.cpp:77-83``). The matrices come back as f32 tensors on the
    ``device`` asked for."""

    position: tuple = (0.0, -10.0, -13.0)
    euler_angles: tuple = (0.0, 0.0, 0.0)
    fov_degrees: float = 70.0
    near: float = 0.1
    far: float = 10000.0
    orthographic: bool = False

    def rotation(self, device) -> torch.Tensor:
        """``Camera::rotation`` (``scene.cpp:761-764``), with the
        reference's host trigonometry (:func:`orientate4_host`)."""
        return orientate4_host(self.euler_angles).to(device)

    def transform(self, device) -> torch.Tensor:
        """``transformVk`` of the camera (``geometryhelpers.cpp:147-151``)."""
        (position,) = _f32(self.position, device="cpu")
        return matmul4(translate(position), orientate4_host(self.euler_angles)).to(device)

    def view(self, device) -> torch.Tensor:
        """``viewVk`` of the camera: R^T @ T(-p)."""
        (position,) = _f32(self.position, device="cpu")
        return matmul4(orientate4_host(self.euler_angles).T, translate(-position)).to(device)

    def projection(self, aspect_ratio: float, device) -> torch.Tensor:
        """``Camera::projection`` (``scene.cpp:776-794``)."""
        if self.orthographic:
            height = math.tan(math.radians(self.fov_degrees) / 2.0)
            mn, mx = _f32(
                (-aspect_ratio * height, -height, self.near),
                (aspect_ratio * height, height, self.far),
                device=device,
            )
            return projection_ortho_vk(mn, mx)
        return perspective_vk(*_f32(self.fov_degrees, aspect_ratio, self.near, self.far, device=device))

    def packed(self, aspect_ratio: float, device) -> CameraPacked:
        """``Camera::toDeviceEquivalent`` (``scene.cpp:739-754``)."""
        return pack_camera(
            *_f32(
                self.position, self.euler_angles, self.fov_degrees, self.near, self.far,
                aspect_ratio, device=device,
            ),
            orthographic=self.orthographic,
        )

    def handle_input(
        self,
        delta_time_seconds: float,
        cursor_delta=(0.0, 0.0),
        keys: frozenset = frozenset(),
        speed: float = 20.0,
    ) -> None:
        """WASDQE fly controls + mouse look (``scene.cpp:401-458``): the
        cursor turns yaw and pitch (pitch clamped to +-pi/2), the keys move
        along the rotated forward and right axes and the unrotated world up
        (``scene.cpp:423-424``). ``speed`` defaults to
        ``DEFAULT_CAMERA_CONTROLLED_SPEED`` (``scene.cpp:85``). Host
        arithmetic in the reference's order: the angles in Python floats,
        the move in f32."""
        ex, ey, ez = self.euler_angles
        ez += cursor_delta[0] / 100.0
        ex = max(-math.pi / 2, min(math.pi / 2, ex - cursor_delta[1] / 200.0))
        self.euler_angles = (ex, ey, ez)

        rot = orientate4_host(self.euler_angles)[:3, :3]
        cpu = torch.device("cpu")
        forward = dot3_fma(rot, world_forward(cpu))
        right = dot3_fma(rot, world_right(cpu))
        up = world_up(cpu)
        move = torch.zeros(3, dtype=F32)
        for plus, minus, axis in (("w", "s", forward), ("d", "a", right), ("e", "q", up)):
            if plus in keys:
                move = move + axis
            if minus in keys:
                move = move - axis
        step = torch.tensor(speed * delta_time_seconds, dtype=F32)
        position = torch.tensor(self.position, dtype=F32) + step * move
        self.position = tuple(float(x) for x in position)
