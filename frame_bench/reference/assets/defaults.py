"""The built-in default textures that the glTF loader falls back on.

A frozen copy of the port's ``assets/defaults.py``
(``AssetLibrary::loadDefaultAssets``, ``assets/assets.cpp:1286-1614``):
64x64 grey checkerboard color map, flat normal map, non-occluded
dielectric ORM map.
"""

from __future__ import annotations

import numpy as np

from frame_bench.reference.assets.types import MaterialData, TextureLibrary


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
