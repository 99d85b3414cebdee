"""``editor-default``: upstream Syzygy's built-in editor scene.

``editor/editor.cpp:507-568``: two 5x cubes floating at y=-8, a 20x20
floor plane and one red spotlight aimed at the first cube from offset
(-20,-20,-20), with the default assets of ``assets/assets.cpp:1286-1614``
(64x64 grey checkerboard color map, flat normal map, non-occluded
dielectric ORM map; plane and cube meshes with CW front faces in the
+y-down basis). A frozen copy of the port's ``assets/defaults.py`` and
``scene/scene.py::default_scene``, split into plain data
(:func:`inputs`) and the calls of a renderer's public scene API that load
it (:func:`build`).
"""

from __future__ import annotations

import numpy as np


def _textures() -> dict:
    """name -> ((64, 64, 4) uint8, srgb) (``assets.cpp:1294-1399``)."""
    dim = 64
    orm = np.zeros((dim, dim, 4), np.uint8)  # NON_OCCLUDED_DIALECTRIC = (255, 60, 0, 0)
    orm[..., 0] = 255
    orm[..., 1] = 60
    y, x = np.mgrid[0:dim, 0:dim]
    light = ((x // 4 + y // 4) % 2) == 0  # 4-px squares, light (200) / dark (100)
    color = np.zeros((dim, dim, 4), np.uint8)
    color[..., :3] = np.where(light[..., None], 200, 100)
    color[..., 3] = 255
    normal = np.zeros((dim, dim, 4), np.uint8)  # (127, 127, 255, 0): unsigned (0, 0, 1)
    normal[..., 0] = 127
    normal[..., 1] = 127
    normal[..., 2] = 255
    # registration order fixes the texture ids: orm, color, normal
    return {"default_orm": (orm, False), "default_color": (color, True), "default_normal": (normal, False)}


def _plane() -> dict:
    """Unit plane in the xz plane, normal up (-y)."""
    return dict(
        positions=np.array([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]], np.float32),
        normals=np.tile(np.array([[0, -1, 0]], np.float32), (4, 1)),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        colors=np.ones((4, 4), np.float32),
        triangles=np.array([[0, 1, 3], [1, 2, 3]], np.int32),
        name="mesh_Plane",
    )


def _cube() -> dict:
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
    return dict(
        positions=np.asarray(positions, np.float32),
        normals=np.asarray(normals, np.float32),
        uvs=np.asarray(uvs, np.float32),
        colors=np.zeros((len(positions), 4), np.float32),  # value-initialized to zero upstream
        triangles=np.asarray(tris, np.int32),
        name="mesh_Cube",
    )


def inputs() -> dict:
    """The scene's inputs as plain data."""
    floating = np.array([0.0, -8.0, 0.0], np.float32)
    offset = np.array([0.0, 0.0, 6.0], np.float32)
    return {
        "textures": _textures(),
        "meshes": {"cube": _cube(), "plane": _plane()},
        # (mesh, instance name, translation, scale)
        "instances": [
            ("cube", "Model_1", floating + offset, (5.0, 5.0, 5.0)),
            ("cube", "Model_2", floating - offset, (5.0, 5.0, 5.0)),
            ("plane", "Floor", np.array([0.0, -1.0, 0.0], np.float32), (20.0, 1.0, 20.0)),
        ],
        # (color, position, target)
        "spotlights": [((1.0, 0.0, 0.0), floating + np.float32(-20.0), floating)],
    }


def build(api, data: dict):
    """(scene, library) from :func:`inputs` through ``api``'s scene API."""
    library = api.TextureLibrary()
    ids = {name: library.register(name, rgba, srgb=srgb) for name, (rgba, srgb) in data["textures"].items()}
    material = api.MaterialData(color=ids["default_color"], normal=ids["default_normal"], orm=ids["default_orm"])
    meshes = {}
    for key, m in data["meshes"].items():
        surfaces = [api.GeometrySurface(first_tri=0, tri_count=len(m["triangles"]), material=material)]
        meshes[key] = api.Mesh(
            m["positions"], m["normals"], m["uvs"], m["colors"], m["triangles"], surfaces, m["name"]
        )
    scene = api.Scene()
    for mesh, name, translation, scale in data["instances"]:
        scene.add_mesh_instance(meshes[mesh], name, [api.TransformHost.make(translation, scale=scale)])
    for color, position, target in data["spotlights"]:
        scene.add_spotlight(color, api.look_at_transform(position, target))
    return scene, library
