"""``dense-field``: 64 instanced UV spheres under upstream's diagonal wave.

``bench.py:226-256``'s stress scene: ``side x side`` UV spheres of radius
1 (``rings`` x ``segments``; 32 x 64 is 3,968 triangles a sphere, 253,952
for the 64) on an 8 m grid at y=-6, drawn as one ``MeshInstanced``
(``renderer/scene.hpp:109-147``) whose instances move by upstream's
hardcoded ``DIAGONAL_WAVE`` (``renderer/scene.cpp:463-527``): each
instance's y is its original y plus ``sin(t + ((x + 10) + (z + 10)) /
3.1415)``. The default textures of ``assets/assets.cpp:1286-1614``; no
light beyond the sun and the moon. A frozen copy of the port's
``scene/scene.py::dense_sphere_field`` and ``assets/defaults.py::
sphere_mesh``, split into plain data (:func:`inputs`) and the calls of a
renderer's public scene API that load it (:func:`build`).
"""

from __future__ import annotations

import sys

import numpy as np

from frame_bench.scenes.editor_default import _textures


def _sphere(rings: int, segments: int) -> dict:
    """UV sphere, radius 1, outward normals, CW front faces from outside."""
    ring_angles = np.linspace(0.0, np.pi, rings + 1, dtype=np.float32)
    seg_angles = np.linspace(0.0, 2 * np.pi, segments + 1, dtype=np.float32)
    theta, phi = np.meshgrid(ring_angles, seg_angles, indexing="ij")
    y = -np.cos(theta)  # +y down: theta=0 is the top at y=-1
    r = np.sin(theta)
    positions = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=-1).reshape(-1, 3)
    uvs = np.stack([phi / (2 * np.pi), theta / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
    tris = []
    for i in range(rings):
        for j in range(segments):
            a, b = i * (segments + 1) + j, i * (segments + 1) + j + 1
            c, d = (i + 1) * (segments + 1) + j + 1, (i + 1) * (segments + 1) + j
            if i > 0:
                tris.append([a, b, c])
            if i < rings - 1:
                tris.append([a, c, d])
    return dict(
        positions=positions.astype(np.float32),
        normals=positions.astype(np.float32),
        uvs=uvs,
        colors=np.ones((positions.shape[0], 4), np.float32),
        triangles=np.asarray(tris, np.int32),
        name="mesh_Sphere",
    )


def inputs(rings: int = 32, segments: int = 64, side: int = 8) -> dict:
    """The scene's inputs as plain data (the defaults: ``bench.py``'s)."""
    return {
        "textures": _textures(),
        "sphere": _sphere(rings, segments),
        "translations": np.array(
            [(8.0 * (i % side) - 4.0 * side, -6.0, 8.0 * (i // side) - 4.0 * side) for i in range(side * side)],
            np.float32,
        ),
    }


def build(api, data: dict):
    """(scene, library) from :func:`inputs` through ``api``'s scene API."""
    library = api.TextureLibrary()
    ids = {name: library.register(name, rgba, srgb=srgb) for name, (rgba, srgb) in data["textures"].items()}
    material = api.MaterialData(color=ids["default_color"], normal=ids["default_normal"], orm=ids["default_orm"])
    m = data["sphere"]
    surfaces = [api.GeometrySurface(first_tri=0, tri_count=len(m["triangles"]), material=material)]
    mesh = api.Mesh(m["positions"], m["normals"], m["uvs"], m["colors"], m["triangles"], surfaces, m["name"])
    wave = sys.modules[api.Scene.__module__].InstanceAnimation.DIAGONAL_WAVE
    scene = api.Scene()
    scene.add_mesh_instance(
        mesh, "spheres", [api.TransformHost.make(t) for t in data["translations"]], animation=wave
    )
    return scene, library
