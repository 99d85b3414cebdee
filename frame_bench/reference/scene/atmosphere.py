"""Atmosphere parameters, sun animation, and sun/moon light baking.

Port of ``syzygy_tpu/scene/atmosphere.py`` (``renderer/scene.cpp:44-91``,
``:584-623``, ``:694-737``). Host state is a dataclass; the raw per-frame
snapshot is numpy; the packed forms are tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from frame_bench.reference.device import constant, to_tensor
from frame_bench.reference.math.geometry import AABB, aabb_from_min_max, forward_from_eulers, vec_norm, world_up
from frame_bench.reference.scene.lights import DirectionalLight, make_directional

KILOMETERS_PER_MEGAMETER = 1000.0
F32 = torch.float32

SUNLIGHT_STRENGTH = 4.0  # scene.cpp:590
SUNSET_COSINE = 0.06  # scene.cpp:723
MOONRISE_LENGTH = 0.12  # scene.cpp:603
MOONLIGHT_COLOR_RGBA = (0.3, 0.4, 0.6, 1.0)  # scene.cpp:612


@dataclasses.dataclass
class Atmosphere:
    """Editable atmosphere state, Earth defaults (``scene.cpp:52-75``).
    Lengths in megameters, coefficients per megameter."""

    sun_euler_angles: tuple = (1.0, 0.0, 0.0)
    planet_radius_mm: float = 6.360
    atmosphere_radius_mm: float = 6.420
    ground_color: tuple = (1.0, 1.0, 1.0)
    scattering_rayleigh_per_mm: tuple = (5.802, 13.558, 33.1)
    absorption_rayleigh_per_mm: tuple = (0.0, 0.0, 0.0)
    altitude_decay_rayleigh_mm: float = 8.0 / KILOMETERS_PER_MEGAMETER
    scattering_mie_per_mm: tuple = (3.996, 3.996, 3.996)
    absorption_mie_per_mm: tuple = (4.40, 4.40, 4.40)
    altitude_decay_mie_mm: float = 1.2 / KILOMETERS_PER_MEGAMETER
    scattering_ozone_per_mm: tuple = (0.0, 0.0, 0.0)
    absorption_ozone_per_mm: tuple = (0.650, 1.881, 0.085)
    sun_intensity_spectrum: tuple = (1.0, 1.0, 1.0)
    sun_angular_radius: float = math.radians(32.0 / 60.0)

    def _sun_eulers(self, device) -> torch.Tensor:
        return torch.tensor(np.asarray(self.sun_euler_angles, np.float32), device=device)

    def direction_to_sun(self, device) -> torch.Tensor:
        """``Atmosphere::directionToSun`` (``scene.cpp:689-692``)."""
        return -forward_from_eulers(self._sun_eulers(device))

    def packed(self, device) -> "AtmospherePacked":
        """``Atmosphere::toDeviceEquivalent`` (``scene.cpp:694-716``) on
        ``device``: :func:`pack_atmosphere` of the raw snapshot."""
        return pack_atmosphere(AtmosphereRaw(*[to_tensor(x, device) for x in atmosphere_raw(self)]))

    def baked(self, scene_bounds: AABB) -> "AtmosphereBaked":
        """``Atmosphere::baked`` (``scene.cpp:718-737``) on the bounds'
        device: packed + sun/moon lights."""
        dev = scene_bounds.center.device
        eulers = self._sun_eulers(dev)
        return AtmosphereBaked(
            atmosphere=self.packed(dev),
            sunlight=_create_sunlight(scene_bounds, eulers),
            moonlight=_create_moonlight(scene_bounds, _sun_cosine(eulers), SUNSET_COSINE),
        )


class AtmosphereRaw(NamedTuple):
    """Raw per-frame atmosphere parameters (engine basis, megameters)."""

    sun_euler_angles: np.ndarray  # (3,)
    planet_radius_mm: np.ndarray
    atmosphere_radius_mm: np.ndarray
    scattering_rayleigh_per_mm: np.ndarray
    absorption_rayleigh_per_mm: np.ndarray
    density_scale_rayleigh_mm: np.ndarray
    scattering_mie_per_mm: np.ndarray
    absorption_mie_per_mm: np.ndarray
    density_scale_mie_mm: np.ndarray
    scattering_ozone_per_mm: np.ndarray
    absorption_ozone_per_mm: np.ndarray
    sun_intensity_spectrum: np.ndarray
    sun_angular_radius: np.ndarray


def atmosphere_raw(atmo: Atmosphere) -> AtmosphereRaw:
    """Host-side (numpy f32) snapshot of the editable atmosphere state."""

    def f(x):
        return np.asarray(x, np.float32)

    return AtmosphereRaw(
        sun_euler_angles=f(atmo.sun_euler_angles),
        planet_radius_mm=f(atmo.planet_radius_mm),
        atmosphere_radius_mm=f(atmo.atmosphere_radius_mm),
        scattering_rayleigh_per_mm=f(atmo.scattering_rayleigh_per_mm),
        absorption_rayleigh_per_mm=f(atmo.absorption_rayleigh_per_mm),
        density_scale_rayleigh_mm=f(atmo.altitude_decay_rayleigh_mm),
        scattering_mie_per_mm=f(atmo.scattering_mie_per_mm),
        absorption_mie_per_mm=f(atmo.absorption_mie_per_mm),
        density_scale_mie_mm=f(atmo.altitude_decay_mie_mm),
        scattering_ozone_per_mm=f(atmo.scattering_ozone_per_mm),
        absorption_ozone_per_mm=f(atmo.absorption_ozone_per_mm),
        sun_intensity_spectrum=f(atmo.sun_intensity_spectrum),
        sun_angular_radius=f(atmo.sun_angular_radius),
    )


class AtmospherePacked(NamedTuple):
    """Device-facing atmosphere (``gputypes.hpp:39-72``), +y up, Mm."""

    scattering_rayleigh_per_mm: torch.Tensor
    density_scale_rayleigh_mm: torch.Tensor
    absorption_rayleigh_per_mm: torch.Tensor
    planet_radius_mm: torch.Tensor
    scattering_mie_per_mm: torch.Tensor
    density_scale_mie_mm: torch.Tensor
    absorption_mie_per_mm: torch.Tensor
    atmosphere_radius_mm: torch.Tensor
    incident_direction_sun: torch.Tensor
    scattering_ozone_per_mm: torch.Tensor
    absorption_ozone_per_mm: torch.Tensor
    sun_intensity_spectrum: torch.Tensor
    sun_angular_radius: torch.Tensor


def pack_atmosphere(raw: AtmosphereRaw) -> AtmospherePacked:
    """``Atmosphere::toDeviceEquivalent`` (``scene.cpp:694-716``) on
    tensors: the sky basis is +y up, hence the y flip of the sun."""
    sun_dir = -forward_from_eulers(raw.sun_euler_angles)
    sun_dir = sun_dir / vec_norm(sun_dir)
    sun_dir = sun_dir * constant([1.0, -1.0, 1.0], F32, sun_dir.device)
    return AtmospherePacked(
        scattering_rayleigh_per_mm=raw.scattering_rayleigh_per_mm,
        density_scale_rayleigh_mm=raw.density_scale_rayleigh_mm,
        absorption_rayleigh_per_mm=raw.absorption_rayleigh_per_mm,
        planet_radius_mm=raw.planet_radius_mm,
        scattering_mie_per_mm=raw.scattering_mie_per_mm,
        density_scale_mie_mm=raw.density_scale_mie_mm,
        absorption_mie_per_mm=raw.absorption_mie_per_mm,
        atmosphere_radius_mm=raw.atmosphere_radius_mm,
        incident_direction_sun=-sun_dir,
        scattering_ozone_per_mm=raw.scattering_ozone_per_mm,
        absorption_ozone_per_mm=raw.absorption_ozone_per_mm,
        sun_intensity_spectrum=raw.sun_intensity_spectrum,
        sun_angular_radius=raw.sun_angular_radius,
    )


class AtmosphereBaked(NamedTuple):
    """``Atmosphere::baked`` (``scene.cpp:718-737``): the packed atmosphere
    with its sun and moon lights."""

    atmosphere: AtmospherePacked
    sunlight: DirectionalLight
    moonlight: DirectionalLight


def _create_sunlight(scene_bounds: AABB, sun_euler_angles: torch.Tensor) -> DirectionalLight:
    """``createSunlight`` (``scene.cpp:584-598``)."""
    dev = sun_euler_angles.device
    return make_directional(
        color=constant([1.0, 1.0, 1.0, 1.0], F32, dev),
        strength=constant(SUNLIGHT_STRENGTH, F32, dev),
        euler_angles=sun_euler_angles,
        captured_bounds=scene_bounds,
    )


def _create_moonlight(scene_bounds: AABB, sun_cosine: torch.Tensor, sunset_cosine: float) -> DirectionalLight:
    """``createMoonlight`` (``scene.cpp:599-623``), keeping the reference's
    quirk: ``glm::clamp(0, 1, x)`` with its arguments transposed evaluates
    to ``min(1, x)``."""
    dev = sun_cosine.device
    return make_directional(
        color=constant(MOONLIGHT_COLOR_RGBA, F32, dev),
        strength=0.02 * torch.clamp(torch.abs(sun_cosine - sunset_cosine) / MOONRISE_LENGTH, max=1.0),
        euler_angles=constant([-math.pi / 2.0, 0.0, 0.0], F32, dev),
        captured_bounds=scene_bounds,
    )


def _sun_cosine(sun_euler_angles: torch.Tensor) -> torch.Tensor:
    """The sun's height: world up against the direction to the sun."""
    return torch.sum(world_up(sun_euler_angles.device) * -forward_from_eulers(sun_euler_angles))


def bake_directional(raw: AtmosphereRaw, bounds_min, bounds_max) -> DirectionalLight:
    """Sun + moon baking (``scene.cpp:584-623,718-737``): a stacked (2, ...)
    DirectionalLight, row 0 = sun, row 1 = moon."""
    bounds = aabb_from_min_max(bounds_min, bounds_max)
    sunlight = _create_sunlight(bounds, raw.sun_euler_angles)
    moonlight = _create_moonlight(bounds, _sun_cosine(raw.sun_euler_angles), SUNSET_COSINE)
    return DirectionalLight(
        *[torch.stack([a, b]) for a, b in zip(sunlight, moonlight)]
    )


@dataclasses.dataclass
class SunAnimation:
    """``SunAnimation`` (defaults ``scene.cpp:87-91``)."""

    frozen: bool = False
    time: float = 0.5
    speed: float = 100.0
    skip_night: bool = False

    DAY_LENGTH_SECONDS = 60.0 * 60.0 * 24.0

    def tick(self, delta_time_seconds: float) -> None:
        """Advance time-of-day (``scene.cpp:532-563``)."""
        if not self.frozen:
            self.time = (
                self.time + self.speed * delta_time_seconds / self.DAY_LENGTH_SECONDS
            ) % 1.0
        if self.skip_night and not self.frozen:
            sunset_length = 0.015
            horizon_a = 0.25 - sunset_length
            horizon_b = 0.75 + sunset_length
            if self.time < horizon_a or self.time > horizon_b:
                self.time = horizon_a if self.speed > 0.0 else horizon_b

    def sun_pitch_radians(self) -> float:
        """Straight down at t=0, one wrap per day (``scene.cpp:565-574``)."""
        start = math.pi / 2.0
        end = start + 2.0 * math.pi
        return start + (end - start) * self.time
