"""Host-side assets (port of ``syzygy_tpu/assets``)."""

from syzygy_tpu_torch.assets.defaults import (
    cube_mesh,
    plane_mesh,
    register_default_textures,
    sphere_mesh,
)
from syzygy_tpu_torch.assets.types import (
    GeometrySurface,
    MaterialData,
    Mesh,
    TextureLibrary,
    srgb_to_linear,
)

__all__ = [
    "cube_mesh",
    "plane_mesh",
    "register_default_textures",
    "sphere_mesh",
    "GeometrySurface",
    "MaterialData",
    "Mesh",
    "TextureLibrary",
    "srgb_to_linear",
]
