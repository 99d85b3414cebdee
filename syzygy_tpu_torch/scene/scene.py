"""Scene graph: instanced meshes, lights, camera, atmosphere, animation.

Numpy port of ``syzygy_tpu/scene/scene.py`` (``renderer/scene.hpp`` /
``scene.cpp``): instanced meshes with SoA transform blocks, up to 20
cameras with fly input, ``Scene.tick``, the shadow-bounds AABB
(``scene.cpp:95-148``) and the default editor scene
(``editor/editor.cpp:507-568``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np

from syzygy_tpu_torch.assets.defaults import (
    cube_mesh,
    plane_mesh,
    register_default_textures,
)
from syzygy_tpu_torch.assets.types import Mesh, TextureLibrary
from syzygy_tpu_torch.scene.atmosphere import Atmosphere, SunAnimation
from syzygy_tpu_torch.scene.camera import Camera
from syzygy_tpu_torch.scene.lights import SpotlightParams


class InstanceAnimation(enum.Enum):
    NONE = 0
    DIAGONAL_WAVE = 1
    SPIN_ALONG_WORLD_UP = 2


@dataclasses.dataclass
class TransformHost:
    """Host-side TRS (``geometry/transform.hpp:13-22``)."""

    translation: np.ndarray
    euler_angles: np.ndarray
    scale: np.ndarray

    @staticmethod
    def make(translation=(0, 0, 0), euler_angles=(0, 0, 0), scale=(1, 1, 1)):
        return TransformHost(
            np.asarray(translation, np.float32).copy(),
            np.asarray(euler_angles, np.float32).copy(),
            np.asarray(scale, np.float32).copy(),
        )

    def to_matrix(self) -> np.ndarray:
        """``Transform::toMatrix`` = T @ R @ S (host, numpy)."""
        px, py, pz = self.translation
        pitch, roll, yaw = self.euler_angles
        cy, sy = math.cos(yaw), math.sin(yaw)
        cp, sp = math.cos(pitch), math.sin(pitch)
        cr, sr = math.cos(roll), math.sin(roll)
        rot = np.array(
            [
                [cy * cr + sy * sp * sr, -cy * sr + sy * sp * cr, sy * cp],
                [sr * cp, cr * cp, -sp],
                [-sy * cr + cy * sp * sr, sr * sy + cy * sp * cr, cy * cp],
            ],
            np.float32,
        )
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot * np.asarray(self.scale, np.float32)[None, :]
        m[:3, 3] = (px, py, pz)
        return m


def look_at_transform(position, target, scale=(1.0, 1.0, 1.0)) -> TransformHost:
    """``Transform::lookAt`` (``transform.cpp:17-28``)."""
    fwd = np.asarray(target, np.float32) - np.asarray(position, np.float32)
    n = np.linalg.norm(fwd)
    if n < 1e-12:
        eulers = np.zeros(3, np.float32)
    else:
        f = fwd / n
        pitch = math.asin(np.clip(-f[1], -1.0, 1.0))
        yaw = math.atan2(f[0], f[2])
        eulers = np.array([pitch, 0.0, yaw], np.float32)
    return TransformHost.make(position, eulers, scale)


@dataclasses.dataclass
class MeshInstance:
    """``MeshInstanced`` (``renderer/scene.hpp:109-147``).

    Transforms live in SoA blocks (``translations``/``eulers``/``scales``,
    each (N, 3)) that the animation tick and ``pack_frame_params`` read as
    arrays. ``transforms`` and ``originals`` hold :class:`TransformHost`
    rows whose fields are VIEWS into the blocks: edit them in place
    (``t.scale[:] = 2``), never rebind a field.

    As in the reference, an original's translation is a view of
    ``orig_translations`` while its euler angles and scale are copies of
    the CURRENT transform's, taken by :meth:`set_transforms`: the originals
    handed in lend only their translations.
    """

    mesh: Optional[Mesh]
    name: str
    render: bool = True
    casts_shadow: bool = True
    animation: InstanceAnimation = InstanceAnimation.NONE
    originals: list = dataclasses.field(default_factory=list)
    transforms: list = dataclasses.field(default_factory=list)
    translations: Optional[np.ndarray] = None
    eulers: Optional[np.ndarray] = None
    scales: Optional[np.ndarray] = None
    orig_translations: Optional[np.ndarray] = None
    # None, or one entry per mesh surface: a MaterialData that replaces the
    # surface's own at pack time, or None to keep it
    material_overrides: Optional[list] = None

    def __post_init__(self):
        if self.translations is None:
            self.set_transforms(self.transforms, self.originals or None)

    def set_material_override(self, surface_index: int, material) -> None:
        """Override one surface's material (the per-surface descriptors of
        ``MeshInstanced``)."""
        if self.material_overrides is None:
            self.material_overrides = [None] * len(self.mesh.surfaces)
        self.material_overrides[surface_index] = material

    def set_transforms(self, transforms, originals=None) -> None:
        """Adopt a list of TransformHost as SoA blocks + row views."""

        def block(rows, field):
            out = np.zeros((len(transforms), 3), np.float32)
            for i, t in enumerate(rows):
                out[i] = np.asarray(getattr(t, field), np.float32)
            return out

        self.translations = block(transforms, "translation")
        self.eulers = block(transforms, "euler_angles")
        self.scales = block(transforms, "scale")
        self.orig_translations = block(originals if originals is not None else transforms, "translation")
        n = len(transforms)
        self.transforms = [TransformHost(self.translations[i], self.eulers[i], self.scales[i]) for i in range(n)]
        self.originals = [
            TransformHost(self.orig_translations[i], self.eulers[i].copy(), self.scales[i].copy())
            for i in range(n)
        ]

    def tick(self, time_elapsed: float, delta_time: float) -> None:
        """Instance animations (``scene.cpp:463-527``)."""
        if self.animation == InstanceAnimation.DIAGONAL_WAVE:
            orig = self.orig_translations
            offset = (orig[:, 0] + 10.0 + orig[:, 2] + 10.0) / 3.1415
            self.translations[:, 0] = orig[:, 0]
            self.translations[:, 1] = orig[:, 1] + np.sin(
                time_elapsed + offset
            ).astype(np.float32)
            self.translations[:, 2] = orig[:, 2]
        elif self.animation == InstanceAnimation.SPIN_ALONG_WORLD_UP:
            self.eulers[:, 2] += delta_time

    def model_matrices(self) -> np.ndarray:
        """(N, 4, 4) ``Transform::toMatrix`` of every transform."""
        return np.stack([t.to_matrix() for t in self.transforms])


def _aabb_corners(vmin, vmax) -> np.ndarray:
    return np.array(
        [
            [x, y, z]
            for x in (vmin[0], vmax[0])
            for y in (vmin[1], vmax[1])
            for z in (vmin[2], vmax[2])
        ],
        np.float32,
    )


@dataclasses.dataclass
class Scene:
    """``Scene`` (``renderer/scene.hpp:154-218``).

    Holds up to ``MAX_CAMERAS`` cameras (the renderer's camera buffer,
    ``renderer/renderer.hpp:113-121``); ``camera`` is the active one,
    ``cameras[camera_index]``."""

    MAX_CAMERAS = 20  # renderer.hpp:113-121

    cameras: list = dataclasses.field(default_factory=lambda: [Camera()])
    camera_index: int = 0
    camera_speed: float = 20.0  # DEFAULT_CAMERA_CONTROLLED_SPEED, scene.cpp:85
    atmosphere: Atmosphere = dataclasses.field(default_factory=Atmosphere)
    sun_animation: SunAnimation = dataclasses.field(default_factory=SunAnimation)
    spotlights: list = dataclasses.field(default_factory=list)
    spotlights_render: bool = False
    geometry: list = dataclasses.field(default_factory=list)
    render_atmosphere: bool = True
    time_elapsed: float = 0.0

    @property
    def camera(self) -> Camera:
        return self.cameras[self.camera_index]

    @camera.setter
    def camera(self, cam: Camera) -> None:
        self.cameras[self.camera_index] = cam

    def add_camera(self, camera: Optional[Camera] = None) -> int:
        """Register another camera; returns its index."""
        if len(self.cameras) >= self.MAX_CAMERAS:
            raise ValueError(f"camera capacity {self.MAX_CAMERAS} reached")
        self.cameras.append(camera if camera is not None else Camera())
        return len(self.cameras) - 1

    def add_mesh_instance(
        self,
        mesh: Optional[Mesh],
        name: str,
        transforms,
        animation: InstanceAnimation = InstanceAnimation.NONE,
        casts_shadow: bool = True,
    ) -> MeshInstance:
        """``Scene::addMeshInstance`` (``scene.cpp:157-214``).

        The instance's scales are then normalized by the mesh, and its
        originals keep the scales from before (see :class:`MeshInstance`):
        a reset restores the unnormalized scale, as in the reference."""
        instance = MeshInstance(
            mesh=mesh,
            name=f"meshInstanced_{name}",
            casts_shadow=casts_shadow,
            animation=animation,
            originals=[TransformHost.make(t.translation, t.euler_angles, t.scale) for t in transforms],
            transforms=[TransformHost.make(t.translation, t.euler_angles, t.scale) for t in transforms],
        )
        if mesh is not None:
            # MeshInstanced::setMesh normalizes instance scale by the mesh's
            # smallest half-extent, floored at 0.01 (scene.cpp:796-820)
            vmin, vmax = mesh.vertex_bounds
            factor = 1.0 / max(float(((vmax - vmin) * 0.5).min()), 0.01)
            instance.scales *= np.float32(factor)
        self.geometry.append(instance)
        return instance

    def add_spotlight(self, color, transform: TransformHost) -> None:
        """``Scene::addSpotlight`` (``scene.cpp:216-234``)."""
        self.spotlights.append(
            SpotlightParams(
                color=(float(color[0]), float(color[1]), float(color[2]), 1.0),
                euler_angles=tuple(float(x) for x in transform.euler_angles),
                position=tuple(float(x) for x in transform.translation),
            )
        )
        self.spotlights_render = True

    def tick(self, delta_time_seconds: float) -> None:
        """``Scene::tick`` (``scene.cpp:532-580``)."""
        self.time_elapsed += delta_time_seconds
        self.sun_animation.tick(delta_time_seconds)
        pitch = self.sun_animation.sun_pitch_radians()
        _, y, z = self.atmosphere.sun_euler_angles
        self.atmosphere.sun_euler_angles = (pitch, y, z)
        for instance in self.geometry:
            instance.tick(self.time_elapsed, delta_time_seconds)

    def shadow_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """World AABB over all shadow-casting geometry
        (``scene.cpp:95-148``), numpy f32. Takes the C++ core
        (:mod:`syzygy_tpu_torch.native`) when it loads and the numpy path
        below otherwise, as the reference does: the two differ in the
        last bits where the compiled core contracts into fused
        multiply-adds, and each matches the reference's path of its
        kind bitwise."""
        from syzygy_tpu_torch import native

        if native.available():
            corners, trs = [], []
            for instance in self.geometry:
                if not instance.casts_shadow or not instance.render or instance.mesh is None:
                    continue
                cs = _aabb_corners(*instance.mesh.vertex_bounds)
                for t in instance.transforms:
                    corners.append(cs)
                    trs.append((t.translation, t.euler_angles, t.scale))
            if not trs:
                return np.zeros(3, np.float32), np.zeros(3, np.float32)
            mats = native.trs_to_matrices(*(np.asarray([x[k] for x in trs], np.float32) for k in range(3)))
            _, mn, mx = native.shadow_bounds(np.ones(len(trs), np.uint8), np.stack(corners), mats)
            return mn, mx

        mn = np.full(3, np.finfo(np.float32).max, np.float32)
        mx = np.full(3, np.finfo(np.float32).min, np.float32)
        found = False
        for instance in self.geometry:
            if not instance.casts_shadow or not instance.render or instance.mesh is None:
                continue
            corners = _aabb_corners(*instance.mesh.vertex_bounds)
            corners_h = np.concatenate([corners, np.ones((8, 1), np.float32)], axis=1)
            for transform in instance.transforms:
                world = (transform.to_matrix() @ corners_h.T).T[:, :3]
                mn = np.minimum(mn, world.min(axis=0))
                mx = np.maximum(mx, world.max(axis=0))
                found = True
        if not found:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return mn, mx

    def handle_input(self, delta_time, cursor_delta=(0.0, 0.0), keys=frozenset()) -> None:
        """Fly the active camera (``Scene::handleInput``)."""
        self.camera.handle_input(delta_time, cursor_delta, keys, speed=self.camera_speed)


def default_scene(
    texture_library: Optional[TextureLibrary] = None,
) -> tuple[Scene, TextureLibrary]:
    """The editor's built-in scene (``editor/editor.cpp:507-568``): two 5x
    cubes floating at y=-8, a 20x20 floor plane, and a red spotlight aimed
    at the first cube from offset (-20,-20,-20)."""
    library = texture_library or TextureLibrary()
    material = register_default_textures(library)
    cube = cube_mesh(material)
    plane = plane_mesh(material)

    scene = Scene()
    floating = np.array([0.0, -8.0, 0.0], np.float32)
    mesh_scale = (5.0, 5.0, 5.0)
    offset = np.array([0.0, 0.0, 6.0], np.float32)
    scene.add_mesh_instance(
        cube, "Model_1", [TransformHost.make(floating + offset, scale=mesh_scale)]
    )
    scene.add_mesh_instance(
        cube, "Model_2", [TransformHost.make(floating - offset, scale=mesh_scale)]
    )
    scene.add_mesh_instance(
        plane, "Floor", [TransformHost.make((0.0, -1.0, 0.0), scale=(20.0, 1.0, 20.0))]
    )
    scene.add_spotlight(
        (1.0, 0.0, 0.0), look_at_transform(floating + np.float32(-20.0), floating)
    )
    return scene, library


def dense_sphere_field(
    rings: int = 32, segments: int = 64, side: int = 8
) -> tuple[Scene, TextureLibrary]:
    """The raster-bound benchmark scene (``bench.py:226-253``): side x side
    UV spheres on an 8 m grid at y=-6 (64 x 3968 = 253,952 triangles at
    the default tessellation), camera looking at the field."""
    from syzygy_tpu_torch.assets.defaults import sphere_mesh

    scene = Scene()
    library = TextureLibrary()
    mesh = sphere_mesh(register_default_textures(library), rings=rings, segments=segments)
    scene.add_mesh_instance(
        mesh,
        "spheres",
        [
            TransformHost.make(
                (8.0 * (i % side) - 4.0 * side, -6.0, 8.0 * (i // side) - 4.0 * side)
            )
            for i in range(side * side)
        ],
    )
    scene.tick(0.0)
    return scene, library
