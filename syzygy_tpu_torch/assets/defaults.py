"""Built-in default assets: textures + plane/cube/sphere meshes.

Numpy port of ``syzygy_tpu/assets/defaults.py``
(``AssetLibrary::loadDefaultAssets``, ``assets/assets.cpp:1286-1614``):
64x64 grey checkerboard color map, flat normal map, non-occluded dielectric
ORM map, plane + cube meshes (CW front faces in the +y-down basis), and the
procedural UV sphere used by the dense benchmark field.
"""

from __future__ import annotations

import numpy as np

from syzygy_tpu_torch.assets.types import (
    GeometrySurface,
    MaterialData,
    Mesh,
    TextureLibrary,
)


def register_default_textures(library: TextureLibrary) -> MaterialData:
    """The three default maps (``assets.cpp:1294-1399``)."""
    dim = 64
    # NON_OCCLUDED_DIALECTRIC = (255, 60, 0, 0)
    orm = np.zeros((dim, dim, 4), np.uint8)
    orm[..., 0] = 255
    orm[..., 1] = 60
    orm_id = library.register("default_orm", orm, srgb=False)

    # grey checkerboard, 4-px squares, light (200) / dark (100)
    y, x = np.mgrid[0:dim, 0:dim]
    light = ((x // 4 + y // 4) % 2) == 0
    color = np.zeros((dim, dim, 4), np.uint8)
    color[..., :3] = np.where(light[..., None], 200, 100)
    color[..., 3] = 255
    color_id = library.register("default_color", color, srgb=True)

    # flat normal (127, 127, 255, 0): unsigned encoding of (0, 0, 1)
    normal = np.zeros((dim, dim, 4), np.uint8)
    normal[..., 0] = 127
    normal[..., 1] = 127
    normal[..., 2] = 255
    normal_id = library.register("default_normal", normal, srgb=False)

    return MaterialData(color=color_id, normal=normal_id, orm=orm_id)


def plane_mesh(material: MaterialData) -> Mesh:
    """Unit plane in the xz plane, normal up (-y)."""
    positions = np.array(
        [[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]], np.float32
    )
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    normals = np.tile(np.array([[0, -1, 0]], np.float32), (4, 1))
    colors = np.ones((4, 4), np.float32)
    triangles = np.array([[0, 1, 3], [1, 2, 3]], np.int32)
    surfaces = [GeometrySurface(first_tri=0, tri_count=2, material=material)]
    return Mesh(positions, normals, uvs, colors, triangles, surfaces, "mesh_Plane")


def cube_mesh(material: MaterialData) -> Mesh:
    """2x2x2 cube with per-face UVs (``assets.cpp:1476-1570``)."""
    faces = [
        # (uv_origin, uv_x, uv_y, normal)
        ([-1, -1, 1], [2, 0, 0], [0, 0, -2], [0, -1, 0]),
        ([-1, 1, -1], [2, 0, 0], [0, 0, 2], [0, 1, 0]),
        ([1, -1, -1], [0, 0, 2], [0, 2, 0], [1, 0, 0]),
        ([-1, -1, 1], [0, 0, -2], [0, 2, 0], [-1, 0, 0]),
        ([-1, -1, -1], [2, 0, 0], [0, 2, 0], [0, 0, -1]),
        ([1, -1, 1], [-2, 0, 0], [0, 2, 0], [0, 0, 1]),
    ]
    positions, normals, uvs, tris = [], [], [], []
    for origin, ux, uy, n in faces:
        o, ux, uy, n = (np.asarray(v, np.float32) for v in (origin, ux, uy, n))
        base = len(positions)
        positions += [o, o + ux, o + ux + uy, o + uy]
        uvs += [[0, 0], [1, 0], [1, 1], [0, 1]]
        normals += [n] * 4
        tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    # the reference leaves cube vertex colors value-initialized to zero
    colors = np.zeros((len(positions), 4), np.float32)
    surfaces = [GeometrySurface(first_tri=0, tri_count=len(tris), material=material)]
    return Mesh(
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(uvs, np.float32),
        colors,
        np.asarray(tris, np.int32),
        surfaces,
        "mesh_Cube",
    )


def sphere_mesh(material: MaterialData, rings: int = 32, segments: int = 64) -> Mesh:
    """UV sphere, radius 1, outward normals, CW front faces from outside."""
    ring_angles = np.linspace(0.0, np.pi, rings + 1, dtype=np.float32)
    seg_angles = np.linspace(0.0, 2 * np.pi, segments + 1, dtype=np.float32)
    theta, phi = np.meshgrid(ring_angles, seg_angles, indexing="ij")
    y = -np.cos(theta)  # +y down: theta=0 is the top at y=-1
    r = np.sin(theta)
    positions = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=-1).reshape(-1, 3)
    normals = positions.copy()
    uvs = np.stack(
        [phi / (2 * np.pi), theta / np.pi], axis=-1
    ).reshape(-1, 2).astype(np.float32)
    colors = np.ones((positions.shape[0], 4), np.float32)

    def vid(i, j):
        return i * (segments + 1) + j

    tris = []
    for i in range(rings):
        for j in range(segments):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                tris.append([a, b, c])
            if i < rings - 1:
                tris.append([a, c, d])
    surfaces = [GeometrySurface(first_tri=0, tri_count=len(tris), material=material)]
    return Mesh(
        positions.astype(np.float32),
        normals.astype(np.float32),
        uvs,
        colors,
        np.asarray(tris, np.int32),
        surfaces,
        "mesh_Sphere",
    )
