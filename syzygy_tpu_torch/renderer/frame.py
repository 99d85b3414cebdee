"""The frame graph: scene state to final image.

Port of ``syzygy_tpu/renderer/frame.py`` (``render_frame``,
``frame.py:1155-1167``) on one device, eagerly:

1. geometry: frame state, vertex transforms, one depth raster per shadow
   map that anything samples, the camera triangle setup + visibility
   raster, and the per-triangle resolve records;
2. shading: the transmittance, sky-view (q8), t_seg and aerial LUTs, then
   per pixel the G-buffer resolve, deferred lighting (5x5 PCF on f16
   maps), the sky camera pass and the OETF;
3. supersample box filter and crop.

The TPU-only structure of the reference (three jitted programs, the
68-row ``lax.map`` sky chunks that dodge a TPU compiler crash, quad/joint
atlas packing, PCF segment tables) has no counterpart here; the storage
precisions that change results (f16 atlas, f16 PCF depths, q8 sky-view)
are kept.
"""

from __future__ import annotations

import dataclasses

import torch

from syzygy_tpu_torch.kernels.atmosphere import (
    METERS_PER_MM,
    compute_skyview_lut,
    compute_transmittance_lut,
    pack_lut_q8,
)
from syzygy_tpu_torch.kernels.lighting import deferred_lighting, light_activity
from syzygy_tpu_torch.kernels.raster import TILE_H, TILE_W, rasterize, setup_triangles
from syzygy_tpu_torch.kernels.resolve import (
    build_resolve_records,
    resolve_gbuffer_from_records,
    transform_normals,
    transform_positions,
)
from syzygy_tpu_torch.kernels.sky import (
    build_aerial_lut,
    compute_skyview_tseg,
    pack_tseg_rows,
    sky_camera_pass,
)
from syzygy_tpu_torch.kernels.transfer import oetf_pure_gamma, oetf_srgb
from syzygy_tpu_torch.math.geometry import matmul4, matvec
from syzygy_tpu_torch.scene.lights import MAX_SPOT_LIGHTS
from syzygy_tpu_torch.scene.pack import FrameParams, GeometryStatic, prepare_frame_state

N_DIRECTIONAL = 2  # sun + moon

F32 = torch.float32


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static frame configuration with the reference's field names and
    defaults (``frame.py:184-512``).

    Honoured: the dimensions, shadow-map count/bias, LUT dims,
    ``pcf_f16``, ``shadowless_strength_eps``, ``skyview_q8``/``skyview_f16``,
    ``skyview_tseg``, ``render_atmosphere``, ``oetf``, ``supersample``,
    ``metallic_reflection`` and ``aerial_lut_far_m``. Scheduling-only knobs
    of the TPU build (program fusion, row chunks, tile-list capacity,
    raster tile/chunk sizes, ``raster_vector``, setup sharding,
    ``fast_sky_reflection`` which only the per-pixel-integral sky reads)
    are accepted and ignored. TPU-only modes and features not ported yet
    raise when set away from their defaults (:meth:`check`)."""

    width: int = 1920
    height: int = 1080
    shadow_dim: int = 1024
    n_shadow_maps: int = 10
    shadow_bias_constant: float = 0.0
    shadow_bias_slope: float = 0.0
    skyview_width: int = 2048
    skyview_height: int = 1024
    transmittance_width: int = 512
    transmittance_height: int = 128
    pcf_bitmask: bool = False
    pcf_f16: bool = True
    pcf_q8: bool = False
    pcf_window2d: bool = False
    shadowless_strength_eps: float = 0.025
    share_sun_pcf: bool = False
    skyview_f16: bool = True
    skyview_q8: bool = True
    lut_f16: bool = False
    render_atmosphere: bool = True
    debug_lines: bool = False
    oetf: str = "srgb"
    supersample: int = 1
    tile_list_capacity: int = 448
    raster_tile_h: int = 64
    raster_tile_w: int = 128
    raster_chunk: int = 64
    raster_unroll: bool = True
    raster_vector: bool = True
    sky_row_chunks: int = 0
    fast_sky: bool = False
    aerial_lut: bool = True
    aerial_lut_far_m: float = 4000.0
    skyview_tseg: bool = True
    metallic_reflection: bool = True
    fuse_lighting_sky: bool = True
    fuse_lighting_sky_chunks: bool = True
    resolve_in_sky_chunks: bool = True
    fast_sky_reflection: bool = True
    shard_triangle_setup: bool = True

    # TPU-only modes (gather-layout experiments; must stay at their defaults)
    _TPU_ONLY = {
        "pcf_bitmask": False, "pcf_q8": False, "pcf_window2d": False,
        "lut_f16": False, "share_sun_pcf": False, "raster_unroll": True,
    }
    # features off the ported slice
    _NOT_PORTED = {"aerial_lut": True, "fast_sky": False, "debug_lines": False}

    def check(self) -> None:
        for name, default in {**self._TPU_ONLY, **self._NOT_PORTED}.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"RenderConfig.{name}={getattr(self, name)!r} is not supported "
                    f"by the torch port (only {default!r})"
                )
        if self.oetf not in ("srgb", "pure_gamma"):
            raise ValueError(f"unknown oetf {self.oetf!r}")
        if self.supersample < 1:
            raise ValueError("supersample must be >= 1")
        if self.shadow_dim % TILE_W or self.shadow_dim % TILE_H:
            raise ValueError(f"shadow_dim {self.shadow_dim} is not a multiple of {TILE_W}")

    @property
    def render_width(self) -> int:
        return self.width * self.supersample

    @property
    def render_height(self) -> int:
        return self.height * self.supersample

    @property
    def padded_width(self) -> int:
        return _round_up(self.render_width, TILE_W)

    @property
    def padded_height(self) -> int:
        return _round_up(self.render_height, TILE_H)


def _shadow_pass(geometry: GeometryStatic, world_h, state, config: RenderConfig, maps_to_raster):
    """Depth-only rasters, one per map in ``maps_to_raster``
    (``frame.py:515-687``: front-face culling, reverse-Z, depth bias).
    Every other map stays all-zero, which equals an empty raster."""
    dim = config.shadow_dim
    d, s = state.directional_lights, state.spot_lights
    pv = torch.cat([matmul4(d.projection, d.view), matmul4(s.projection, s.view)], dim=0)
    maps = torch.zeros(
        (N_DIRECTIONAL + MAX_SPOT_LIGHTS, dim, dim), dtype=F32, device=world_h.device
    )
    if not maps_to_raster:
        return maps
    tri_valid = geometry.tri_valid & geometry.tri_casts_shadow
    corners_world = world_h[geometry.triangles.long()]  # (T, 3, 4), gathered once
    for i in maps_to_raster:
        setup = setup_triangles(
            None, geometry.triangles, tri_valid, dim, dim,
            cull_keep_sign=-1,  # front-face culling (pipelines.cpp:654-663)
            corner_clip=matvec(pv[i], corners_world),
            depth_bias_constant=config.shadow_bias_constant,
            depth_bias_slope=config.shadow_bias_slope,
        )
        maps[i] = rasterize(setup, dim, dim, depth_only=True).depth
    return maps


def render_frame_linear(geometry: GeometryStatic, params: FrameParams, config: RenderConfig):
    """Geometry + shading up to the pre-OETF color of the padded render
    target, (padded_height, padded_width, 3). ``params`` holds tensors on
    the geometry's device (:func:`scene.pack.upload_frame_params`)."""
    config.check()
    state = prepare_frame_state(params)
    cam = state.camera
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, matmul4(cam.projection, cam.view)
    )
    world_normals = transform_normals(
        geometry.normals, geometry.vert_instance, state.model_inv_transpose
    )
    activity = light_activity(
        state.directional_lights, state.directional_count, state.directional_skip_count,
        state.spot_lights, state.spot_count, config.shadowless_strength_eps,
        config.n_shadow_maps,
    )
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    shadow_maps = _shadow_pass(geometry, world_h, state, config, activity.shadow_maps)

    setup = setup_triangles(
        clip, geometry.triangles, geometry.tri_valid,
        config.render_width, config.render_height,
        cull_keep_sign=+1,  # back-face cull, CW front (deferred.cpp:503-713)
        grid_width=config.padded_width, grid_height=config.padded_height,
    )
    vis = rasterize(setup, config.padded_width, config.padded_height)
    records = build_resolve_records(setup, geometry, world, world_normals)
    gbuffer = resolve_gbuffer_from_records(vis, records, geometry)

    lit = torch.clamp(
        deferred_lighting(
            gbuffer, cam, state.directional_lights, state.spot_lights, shadow_maps,
            activity, pcf_f16=config.pcf_f16,
        ),
        0.0,
        1.0,
    )
    if not config.render_atmosphere:
        return lit

    atmo = state.atmosphere
    t_lut = compute_transmittance_lut(atmo, config.transmittance_width, config.transmittance_height)
    zero = torch.zeros_like(atmo.planet_radius_mm)
    origin_mm = cam.position[:3] / METERS_PER_MM * torch.tensor(
        [1.0, -1.0, 1.0], dtype=F32, device=zero.device
    ) + torch.stack([zero, atmo.planet_radius_mm, zero])
    sky_arr = compute_skyview_lut(atmo, origin_mm, t_lut, config.skyview_width, config.skyview_height)
    tseg = (
        pack_tseg_rows(compute_skyview_tseg(atmo, t_lut, origin_mm, config.skyview_height))
        if config.skyview_tseg
        else None
    )
    if config.skyview_q8:
        sky_lut = pack_lut_q8(sky_arr)
    else:
        sky_lut = sky_arr.to(torch.float16) if config.skyview_f16 else sky_arr
    t_max_mm = config.aerial_lut_far_m / METERS_PER_MM
    aerial = build_aerial_lut(atmo, t_lut, cam, origin_mm, t_max_mm)
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    color = sky_camera_pass(
        lit, vis.depth, gbuffer, cam, atmo, t_lut, sky_lut, sun, shadow_maps[0],
        draw_extent=(config.render_width, config.render_height),
        aerial=aerial, aerial_t_max=t_max_mm, tseg_rows=tseg,
        metallic_reflection=config.metallic_reflection, pcf_f16=config.pcf_f16,
    )
    return torch.clamp(color, 0.0, 1.0)


def render_frame(geometry: GeometryStatic, params: FrameParams, config: RenderConfig):
    """Scene state -> (height, width, 3) nonlinear-encoded image in [0, 1],
    on the geometry's device."""
    color = render_frame_linear(geometry, params, config)
    ss = config.supersample
    if ss > 1:
        h = (color.shape[0] // ss) * ss
        w = (config.render_width // ss) * ss
        color = color[:h, :w].reshape(h // ss, ss, w // ss, ss, 3).mean(dim=(1, 3))
    encoded = oetf_srgb(color) if config.oetf == "srgb" else oetf_pure_gamma(color)
    return encoded[: config.height, : config.width]
