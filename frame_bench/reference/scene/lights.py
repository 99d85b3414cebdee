"""Directional and spot lights + packed device forms.

Port of ``syzygy_tpu/scene/lights.py`` (``renderer/lights.cpp:9-46``,
``gputypes.hpp:74-115``). Packed lights are NamedTuples of tensors;
fixed-capacity stacks carry validity counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from frame_bench.reference.device import to_tensor
from frame_bench.reference.math.geometry import (
    AABB,
    forward_from_eulers,
    ortho_aabb_vk,
    perspective_vk,
    view_vk,
)

MAX_DIRECTIONAL_LIGHTS = 16  # renderer/renderer.hpp:118
MAX_SPOT_LIGHTS = 16  # renderer/pipelines/deferred.cpp:166-176
MAX_SHADOW_MAPS = 10  # renderer/pipelines/deferred.cpp:179-180

F32 = torch.float32


class DirectionalLight(NamedTuple):
    """``DirectionalLightPacked`` (``gputypes.hpp:74-90``)."""

    color: torch.Tensor  # (..., 4)
    forward: torch.Tensor  # (..., 4)
    projection: torch.Tensor  # (..., 4, 4)
    view: torch.Tensor  # (..., 4, 4)
    strength: torch.Tensor  # (...,)


class SpotLight(NamedTuple):
    """``SpotLightPacked`` (``gputypes.hpp:92-115``)."""

    color: torch.Tensor
    forward: torch.Tensor
    projection: torch.Tensor
    view: torch.Tensor
    position: torch.Tensor
    strength: torch.Tensor
    falloff_factor: torch.Tensor
    falloff_distance: torch.Tensor


def make_directional(color, strength, euler_angles, captured_bounds: AABB) -> DirectionalLight:
    """``makeDirectional`` (``lights.cpp:9-27``): ortho frustum fit to an
    AABB. Tensor arguments on one device."""
    dev = euler_angles.device
    view = view_vk(torch.zeros(3, dtype=F32, device=dev), euler_angles)
    fwd = forward_from_eulers(euler_angles)
    return DirectionalLight(
        color=color,
        forward=torch.cat([fwd, torch.zeros(1, dtype=F32, device=dev)]),
        projection=ortho_aabb_vk(view, captured_bounds),
        view=view,
        strength=strength,
    )


@dataclasses.dataclass
class SpotlightParams:
    """``SpotlightParams`` (``renderer/lights.hpp:14-27``)."""

    color: tuple = (1.0, 1.0, 1.0, 1.0)
    strength: float = 1000.0
    falloff_factor: float = 1.0
    falloff_distance: float = 1.0
    vertical_fov_degrees: float = 30.0
    horizontal_scale: float = 1.0
    euler_angles: tuple = (0.0, 0.0, 0.0)
    position: tuple = (0.0, 0.0, 0.0)
    near: float = 0.1
    far: float = 1000.0


class SpotRaw(NamedTuple):
    """Raw fixed-capacity spot parameters (host numpy, or tensors once
    uploaded)."""

    color: np.ndarray  # (N, 4)
    strength: np.ndarray  # (N,)
    falloff_factor: np.ndarray
    falloff_distance: np.ndarray
    vertical_fov_degrees: np.ndarray
    horizontal_scale: np.ndarray
    euler_angles: np.ndarray  # (N, 3)
    position: np.ndarray  # (N, 3)
    near: np.ndarray
    far: np.ndarray


def spot_raw(params: Sequence[SpotlightParams], capacity: int = MAX_SPOT_LIGHTS):
    """Host fixed-capacity pack of spotlight parameters + count; padded
    rows get parameters that cannot divide by zero."""
    if len(params) > capacity:
        raise ValueError(f"{len(params)} spotlights exceeds capacity {capacity}")
    n = len(params)

    def field(getter, shape=()):
        out = np.zeros((capacity, *shape), np.float32)
        for i, p in enumerate(params):
            out[i] = np.asarray(getter(p), np.float32)
        return out

    raw = SpotRaw(
        color=field(lambda p: p.color, (4,)),
        strength=field(lambda p: p.strength),
        falloff_factor=field(lambda p: p.falloff_factor),
        falloff_distance=field(lambda p: p.falloff_distance),
        vertical_fov_degrees=field(lambda p: p.vertical_fov_degrees),
        horizontal_scale=field(lambda p: p.horizontal_scale),
        euler_angles=field(lambda p: p.euler_angles, (3,)),
        position=field(lambda p: p.position, (3,)),
        near=field(lambda p: p.near),
        far=field(lambda p: p.far),
    )
    pad = np.arange(capacity) >= n
    raw = raw._replace(
        falloff_factor=np.where(pad, 1.0, raw.falloff_factor).astype(np.float32),
        falloff_distance=np.where(pad, 1.0, raw.falloff_distance).astype(np.float32),
        vertical_fov_degrees=np.where(pad, 30.0, raw.vertical_fov_degrees).astype(np.float32),
        horizontal_scale=np.where(pad, 1.0, raw.horizontal_scale).astype(np.float32),
        near=np.where(pad, 0.1, raw.near).astype(np.float32),
        far=np.where(pad, 1000.0, raw.far).astype(np.float32),
    )
    return raw, n


def make_spot_batched(raw: SpotRaw) -> SpotLight:
    """Batched ``makeSpot`` (``lights.cpp:29-46``) over tensor rows."""
    fwd = forward_from_eulers(raw.euler_angles)
    zeros = torch.zeros((*fwd.shape[:-1], 1), dtype=F32, device=fwd.device)
    return SpotLight(
        color=raw.color,
        forward=torch.cat([fwd, zeros], dim=-1),
        projection=perspective_vk(
            raw.vertical_fov_degrees, raw.horizontal_scale, raw.near, raw.far
        ),
        view=view_vk(raw.position, raw.euler_angles),
        position=torch.cat([raw.position, zeros + 1.0], dim=-1),
        strength=raw.strength,
        falloff_factor=raw.falloff_factor,
        falloff_distance=raw.falloff_distance,
    )


def make_spot(params: SpotlightParams, device) -> SpotLight:
    """``makeSpot`` (``lights.cpp:29-46``) of one spotlight on ``device``:
    row 0 of :func:`make_spot_batched`."""
    raw, _ = spot_raw([params], capacity=1)
    batched = make_spot_batched(SpotRaw(*[to_tensor(x, device) for x in raw]))
    return SpotLight(*[x[0] for x in batched])


def _zero_directional(device) -> DirectionalLight:
    eye = torch.eye(4, dtype=F32, device=device)
    return DirectionalLight(
        color=torch.zeros(4, dtype=F32, device=device),
        forward=torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=F32, device=device),
        projection=eye,
        view=eye,
        strength=torch.zeros((), dtype=F32, device=device),
    )


def _zero_spot(device) -> SpotLight:
    eye = torch.eye(4, dtype=F32, device=device)
    return SpotLight(
        color=torch.zeros(4, dtype=F32, device=device),
        forward=torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=F32, device=device),
        projection=eye,
        view=eye,
        position=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=F32, device=device),
        strength=torch.zeros((), dtype=F32, device=device),
        falloff_factor=torch.ones((), dtype=F32, device=device),
        falloff_distance=torch.ones((), dtype=F32, device=device),
    )


def _stack_padded(lights, zero, capacity):
    if len(lights) > capacity:
        raise ValueError(f"{len(lights)} lights exceeds capacity {capacity}")
    padded = list(lights) + [zero] * (capacity - len(lights))
    return type(zero)(*[torch.stack(leaves) for leaves in zip(*padded)])


def stack_directional(lights: Sequence[DirectionalLight], device, capacity: int = MAX_DIRECTIONAL_LIGHTS):
    """Pad to a fixed-capacity stack + count."""
    count = torch.tensor(len(lights), dtype=torch.int32, device=device)
    return _stack_padded(lights, _zero_directional(device), capacity), count


def stack_spot(lights: Sequence[SpotLight], device, capacity: int = MAX_SPOT_LIGHTS):
    count = torch.tensor(len(lights), dtype=torch.int32, device=device)
    return _stack_padded(lights, _zero_spot(device), capacity), count
