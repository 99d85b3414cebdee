"""Frame passes and the CUDA raster kernel wrapper (port of ``syzygy_tpu/kernels``).

Importing the package builds and loads no CUDA library: each kernel
wrapper loads its library when it first launches."""

from syzygy_tpu_torch.kernels.raster import (
    TriSetup,
    VisibilityBuffer,
    rasterize,
    setup_triangles,
)
from syzygy_tpu_torch.kernels.resolve import (
    GBuffer,
    resolve_gbuffer,
    sample_atlas_repeat,
    sample_bilinear_repeat,
    transform_normals,
    transform_positions,
)
from syzygy_tpu_torch.kernels.lighting import convert_pbr, deferred_lighting
from syzygy_tpu_torch.kernels.transfer import (
    gradient_color,
    matrix_color,
    oetf_pure_gamma,
    oetf_srgb,
)

__all__ = [
    "TriSetup",
    "VisibilityBuffer",
    "rasterize",
    "setup_triangles",
    "GBuffer",
    "resolve_gbuffer",
    "sample_atlas_repeat",
    "sample_bilinear_repeat",
    "transform_normals",
    "transform_positions",
    "convert_pbr",
    "deferred_lighting",
    "gradient_color",
    "matrix_color",
    "oetf_pure_gamma",
    "oetf_srgb",
]
