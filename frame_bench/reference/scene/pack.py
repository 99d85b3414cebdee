"""Scene -> device tensors: a frozen copy of the port's ``scene/pack.py``.


* :func:`pack_geometry` -> :class:`GeometryStatic`: one padded triangle soup
  (vertices replicated per instance, Morton-sorted triangles, plain f16
  texture atlas, optionally with a mip pyramid), uploaded to ``device``.
  Rebuilt only on scene edits.
* :func:`pack_frame_params` -> :class:`FrameParams`: tiny numpy arrays for
  one frame; :func:`upload_frame_params` moves them to a device, leaf by
  leaf.
* :func:`prepare_frame_state` -> :class:`FrameState`: the per-frame
  matrices, camera, sun/moon and spot lights, computed on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from frame_bench.reference.device import to_tensor
from frame_bench.reference.math.geometry import inverse4, orientate4
from frame_bench.reference.scene.atmosphere import (
    AtmospherePacked,
    AtmosphereRaw,
    atmosphere_raw,
    bake_directional,
    pack_atmosphere,
)
from frame_bench.reference.scene.camera import CameraPacked, pack_camera
from frame_bench.reference.scene.lights import (
    MAX_SPOT_LIGHTS,
    DirectionalLight,
    SpotLight,
    SpotRaw,
    make_spot_batched,
    spot_raw,
)
from frame_bench.reference.scene.scene import Scene

VERTEX_PAD = 128
TRI_PAD = 128


class GeometryStatic(NamedTuple):
    """Static scene topology on the device."""

    positions: torch.Tensor  # (V, 3) f32, object space
    normals: torch.Tensor  # (V, 3) f32
    uvs: torch.Tensor  # (V, 2) f32
    colors: torch.Tensor  # (V, 4) f32
    vert_instance: torch.Tensor  # (V,) i32 -> models row
    triangles: torch.Tensor  # (T, 3) i32
    tri_material: torch.Tensor  # (T,) i32 -> materials row
    tri_valid: torch.Tensor  # (T,) bool
    tri_casts_shadow: torch.Tensor  # (T,) bool
    materials: torch.Tensor  # (M, 3) i32 color/normal/orm texture ids
    tex_atlas: torch.Tensor  # (A_h, A_w, 4) f16 (or f32) linear light
    tex_rects: torch.Tensor  # (N, 4) i32 [x0, y0, w, h]
    # mip pyramid (pack_geometry(mipmaps=True)): (N, L, 4) i32 per-level
    # rects into the same atlas, or None for single-mip sampling
    tex_rects_mips: torch.Tensor | None = None


class FrameParams(NamedTuple):
    """Per-frame raw state: numpy on the host, tensors once uploaded."""

    translations: np.ndarray  # (I, 3)
    euler_angles: np.ndarray  # (I, 3)
    scales: np.ndarray  # (I, 3)
    cam_position: np.ndarray  # (3,)
    cam_euler_angles: np.ndarray  # (3,)
    cam_fov_degrees: np.ndarray  # ()
    cam_near: np.ndarray  # ()
    cam_far: np.ndarray  # ()
    aspect_ratio: np.ndarray  # ()
    atmosphere: AtmosphereRaw
    bounds_min: np.ndarray  # (3,) shadow bounds (scene.cpp:95-148)
    bounds_max: np.ndarray  # (3,)
    spots: SpotRaw
    spot_count: np.ndarray  # i32
    directional_skip_count: np.ndarray  # i32 (1 when the sky pass lights the sun)
    debug_segments: np.ndarray  # (S, 2, 3) world-space debug line endpoints
    debug_valid: np.ndarray  # (S,) bool


class FrameState(NamedTuple):
    """Derived per-frame device state consumed by the passes."""

    models: torch.Tensor  # (I, 4, 4)
    model_inv_transpose: torch.Tensor  # (I, 4, 4)
    camera: CameraPacked
    atmosphere: AtmospherePacked
    directional_lights: DirectionalLight  # stacked (2: sun, moon)
    directional_count: torch.Tensor  # i32
    directional_skip_count: torch.Tensor  # i32
    spot_lights: SpotLight  # stacked (MAX_SPOT_LIGHTS, ...)
    spot_count: torch.Tensor  # i32
    debug_segments: torch.Tensor  # (S, 2, 3)
    debug_valid: torch.Tensor  # (S,) bool


def _pad_rows(arr: np.ndarray, total: int, fill=0) -> np.ndarray:
    pad = total - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full((pad, *arr.shape[1:]), fill, arr.dtype)], axis=0)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _renderable(scene: Scene):
    return [i for i in scene.geometry if i.mesh is not None and i.render]


def _surface_materials(instance) -> list:
    """Each surface's material, an instance's override in place of the
    mesh's own where it has one (``MeshInstance.material_overrides``)."""
    overrides = instance.material_overrides or [None] * len(instance.mesh.surfaces)
    return [
        override if override is not None else surface.material
        for surface, override in zip(instance.mesh.surfaces, overrides)
    ]


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three 10-bit integer grids into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Stable world-space Morton sort of triangle records. Depth ties in
    the raster resolve by slot order, so this order is part of the output
    and matches the reference's."""
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-6)
    q = np.clip(((centroids - lo) / span * 1023.0).astype(np.uint32), 0, 1023)
    return np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable").astype(np.int64)


def pack_geometry_host(
    scene: Scene, texture_library, spatial_sort: bool = True, atlas_f16: bool = True,
    mipmaps: bool = False,
) -> dict:
    """Numpy half of :func:`pack_geometry`: the GeometryStatic leaves as
    host arrays (the reference's ``pack_geometry(quad_pack=False,
    joint_pack=False)`` arrays; ``tex_rects_mips`` only with ``mipmaps``)."""
    positions, normals, uvs, colors, vert_instance = [], [], [], [], []
    triangles, tri_material, tri_shadow, tri_centroid = [], [], [], []
    materials: list[tuple[int, int, int]] = []
    material_ids: dict[tuple[int, int, int], int] = {}

    vert_base = 0
    instance_index = 0
    for instance in _renderable(scene):
        mesh = instance.mesh
        for transform in instance.transforms:
            positions.append(mesh.positions)
            normals.append(mesh.normals)
            uvs.append(mesh.uvs)
            colors.append(mesh.colors)
            vert_instance.append(np.full(mesh.positions.shape[0], instance_index, np.int32))
            mat4 = np.asarray(transform.to_matrix(), np.float32)
            for surface, material in zip(mesh.surfaces, _surface_materials(instance)):
                key = (material.color, material.normal, material.orm)
                if key not in material_ids:
                    material_ids[key] = len(materials)
                    materials.append(key)
                tris = mesh.triangles[surface.first_tri : surface.first_tri + surface.tri_count]
                triangles.append(tris + vert_base)
                tri_material.append(np.full(len(tris), material_ids[key], np.int32))
                tri_shadow.append(np.full(len(tris), instance.casts_shadow, bool))
                centroid = mesh.positions[tris].mean(axis=1)
                tri_centroid.append(centroid @ mat4[:3, :3].T + mat4[:3, 3])
            vert_base += mesh.positions.shape[0]
            instance_index += 1
    if vert_base == 0:
        raise ValueError("scene has no renderable geometry")

    positions = np.concatenate(positions)
    triangles = np.concatenate(triangles).astype(np.int32)
    tri_material = np.concatenate(tri_material)
    tri_shadow = np.concatenate(tri_shadow)
    if spatial_sort and triangles.shape[0] > 1:
        order = _morton_order(np.concatenate(tri_centroid))
        triangles = triangles[order]
        tri_material = tri_material[order]
        tri_shadow = tri_shadow[order]

    v_cap = _round_up(positions.shape[0], VERTEX_PAD)
    t_cap = _round_up(triangles.shape[0], TRI_PAD)
    tri_valid = np.zeros(t_cap, bool)
    tri_valid[: triangles.shape[0]] = True

    if mipmaps:
        atlas, rects_mips = texture_library.as_atlas_mips()
        rects = rects_mips[:, 0]
    else:
        atlas, rects = texture_library.as_atlas()
        rects_mips = None
    if atlas_f16:
        atlas = atlas.astype(np.float16)
    arrays = dict(
        positions=_pad_rows(positions, v_cap),
        normals=_pad_rows(np.concatenate(normals), v_cap),
        uvs=_pad_rows(np.concatenate(uvs), v_cap),
        colors=_pad_rows(np.concatenate(colors), v_cap),
        vert_instance=_pad_rows(np.concatenate(vert_instance), v_cap),
        triangles=_pad_rows(triangles, t_cap),
        tri_material=_pad_rows(tri_material, t_cap),
        tri_valid=tri_valid,
        tri_casts_shadow=_pad_rows(tri_shadow.astype(bool), t_cap, False),
        materials=np.asarray(materials, np.int32).reshape(-1, 3),
        tex_atlas=atlas,
        tex_rects=rects,
    )
    if rects_mips is not None:
        arrays["tex_rects_mips"] = rects_mips
    return arrays


def geometry_to_device(arrays: dict, device) -> GeometryStatic:
    """Host arrays (by GeometryStatic field name) -> GeometryStatic on
    ``device``; without a ``tex_rects_mips`` entry the field stays None."""
    return GeometryStatic(
        **{name: to_tensor(arrays[name], device) for name in GeometryStatic._fields if name in arrays}
    )


def pack_geometry(
    scene: Scene,
    texture_library,
    device,
    spatial_sort: bool = True,
    atlas_f16: bool = True,
    mipmaps: bool = False,
) -> GeometryStatic:
    """Flatten all renderable instances into one padded triangle soup on
    ``device``. ``atlas_f16`` (default, as the reference) stores the atlas
    in float16; samples widen to f32 before filtering. ``mipmaps`` packs
    a mip pyramid of every texture into the atlas and switches the resolve
    to trilinear minification (the reference's beyond-parity option)."""
    return geometry_to_device(
        pack_geometry_host(scene, texture_library, spatial_sort, atlas_f16, mipmaps), device
    )


def scene_uses_metallic(scene: Scene, texture_library) -> bool:
    """Does any used material (overrides included) have nonzero metallic?
    When not, the metallic reflection bounce multiplies to exactly zero
    and callers may switch it off (``RenderConfig.metallic_reflection=False``)."""
    orm_ids = {
        material.orm
        for instance in _renderable(scene)
        for material in _surface_materials(instance)
    }
    return any(float(texture_library.get(i)[..., 2].max()) > 0.0 for i in orm_ids)


def pack_frame_params(scene: Scene, aspect_ratio: float) -> FrameParams:
    """Numpy-only per-frame snapshot, without debug lines."""
    renderable = _renderable(scene)
    if renderable:
        translations = np.concatenate([i.translations for i in renderable])
        eulers = np.concatenate([i.eulers for i in renderable])
        scales = np.concatenate([i.scales for i in renderable])
    else:
        translations = np.zeros((1, 3), np.float32)
        eulers = np.zeros((1, 3), np.float32)
        scales = np.ones((1, 3), np.float32)
    bounds_min, bounds_max = scene.shadow_bounds()
    spots, spot_count = spot_raw(
        scene.spotlights if scene.spotlights_render else [], MAX_SPOT_LIGHTS
    )
    debug_segments = np.zeros((1, 2, 3), np.float32)
    debug_valid = np.zeros(1, bool)
    f = np.float32
    return FrameParams(
        translations=np.asarray(translations, np.float32),
        euler_angles=np.asarray(eulers, np.float32),
        scales=np.asarray(scales, np.float32),
        cam_position=np.asarray(scene.camera.position, np.float32),
        cam_euler_angles=np.asarray(scene.camera.euler_angles, np.float32),
        cam_fov_degrees=f(scene.camera.fov_degrees),
        cam_near=f(scene.camera.near),
        cam_far=f(scene.camera.far),
        aspect_ratio=f(aspect_ratio),
        atmosphere=atmosphere_raw(scene.atmosphere),
        bounds_min=np.asarray(bounds_min, np.float32),
        bounds_max=np.asarray(bounds_max, np.float32),
        spots=spots,
        spot_count=np.int32(spot_count),
        directional_skip_count=np.int32(1 if scene.render_atmosphere else 0),
        debug_segments=debug_segments,
        debug_valid=debug_valid,
    )


def upload_frame_params(params: FrameParams, device) -> FrameParams:
    """Host FrameParams -> the same structure of tensors on ``device``."""

    def up(x):
        return to_tensor(x, device)

    return FrameParams(
        *[
            type(leaf)(*[up(x) for x in leaf]) if isinstance(leaf, tuple) else up(leaf)
            for leaf in params
        ]
    )


def prepare_frame_state(params: FrameParams) -> FrameState:
    """Per-frame matrices on the device of ``params`` (tensors)."""
    dev = params.translations.device
    rot = orientate4(params.euler_angles)  # (I, 4, 4)
    scales4 = torch.cat(
        [params.scales, torch.ones((*params.scales.shape[:-1], 1), dtype=torch.float32, device=dev)],
        dim=-1,
    )
    models = rot * scales4[..., None, :]
    models[..., 0:3, 3] = params.translations
    return FrameState(
        models=models,
        model_inv_transpose=inverse4(models).transpose(1, 2),
        camera=pack_camera(
            params.cam_position,
            params.cam_euler_angles,
            params.cam_fov_degrees,
            params.cam_near,
            params.cam_far,
            params.aspect_ratio,
        ),
        atmosphere=pack_atmosphere(params.atmosphere),
        directional_lights=bake_directional(
            params.atmosphere, params.bounds_min, params.bounds_max
        ),
        directional_count=torch.full((), 2, dtype=torch.int32, device=dev),
        directional_skip_count=params.directional_skip_count.to(torch.int32),
        spot_lights=make_spot_batched(params.spots),
        spot_count=params.spot_count.to(torch.int32),
        debug_segments=params.debug_segments.to(torch.float32),
        debug_valid=params.debug_valid,
    )
