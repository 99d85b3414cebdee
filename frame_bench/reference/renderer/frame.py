"""The frame graph, plain: scene state to final image, op by op.

A frozen copy of the port's eager frame (``renderer/frame.py``) over the
plain raster of :mod:`frame_bench.reference.kernels.raster`:

1. geometry: frame state, vertex transforms, one depth raster per shadow
   map slot (empty where nothing samples it), the camera triangle setup +
   visibility raster, and the G-buffer resolve;
2. shading: deferred lighting (5x5 PCF); with the atmosphere the
   transmittance and sky-view LUTs and the sky camera pass, over the t_seg
   and aerial LUTs (``aerial_lut``) or with the per-pixel integrals;
3. the supersample box filter, the OETF and the crop.

No CUDA graph, no hand-written kernel, no debug-line overlay.
"""

from __future__ import annotations

import dataclasses

import torch

from frame_bench.reference.device import constant
from frame_bench.reference.kernels.atmosphere import (
    METERS_PER_MM,
    compute_skyview_lut,
    compute_transmittance_lut,
    pack_lut_q8,
)
from frame_bench.reference.kernels.lighting import convert_pbr, deferred_lighting, directional_pcf, light_activity
from frame_bench.reference.kernels.raster import TILE_H, TILE_W, rasterize, setup_triangles
from frame_bench.reference.kernels.resolve import (
    resolve_gbuffer,
    transform_normals,
    transform_positions,
)
from frame_bench.reference.kernels.sky import (
    build_aerial_lut,
    compute_skyview_tseg,
    pack_tseg_rows,
    sky_camera_pass,
)
from frame_bench.reference.kernels.transfer import oetf_pure_gamma, oetf_srgb
from frame_bench.reference.math.geometry import matmul4, matvec
from frame_bench.reference.scene.lights import MAX_SPOT_LIGHTS
from frame_bench.reference.scene.pack import FrameParams, GeometryStatic, prepare_frame_state

N_DIRECTIONAL = 2  # sun + moon

F32 = torch.float32


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static frame configuration with the reference's field names and
    defaults (``frame.py:184-512``).

    Honoured: the dimensions, shadow-map count/bias, LUT dims,
    ``pcf_f16``, ``pcf_q8``, ``shadowless_strength_eps``,
    ``share_sun_pcf``, ``skyview_q8``/``skyview_f16``, ``lut_f16``,
    ``skyview_tseg``, ``render_atmosphere``, ``debug_lines``, ``oetf``,
    ``supersample``, ``metallic_reflection``, ``aerial_lut`` and
    ``aerial_lut_far_m``, ``fast_sky`` and ``fast_sky_reflection`` (read
    by the per-pixel-integral sky only, as in the reference).
    ``shard_triangle_setup`` splits the camera setup and the resolve
    records over the row group of :func:`render_frame_rows` (``group=``).
    ``tile_list_capacity`` sizes the rasters' tile lists
    (``kernels/raster.py::bin_triangles``); lists that would drop a slot,
    and capacity 0, take the full-iteration raster, with the same bits.
    ``pcf_bitmask`` and ``pcf_window2d`` are gather layouts of the same
    PCF taps, and the scheduling-only knobs of the TPU build (program
    fusion, row chunks, raster tile/chunk sizes, ``raster_unroll``,
    ``raster_vector``) are accepted and ignored."""

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

    # sizes that must be positive (the first eight are the reference
    # editor's checks, properties.py:289-295) or at least zero
    _POSITIVE = (
        "width", "height", "shadow_dim", "supersample", "skyview_width", "skyview_height",
        "transmittance_width", "transmittance_height", "raster_tile_h", "raster_tile_w",
        "raster_chunk",
    )
    _NON_NEGATIVE = ("n_shadow_maps", "tile_list_capacity", "sky_row_chunks")

    def check(self) -> None:
        for name in self._POSITIVE + self._NON_NEGATIVE:
            value = getattr(self, name)
            least = 1 if name in self._POSITIVE else 0
            if not isinstance(value, int) or value < least:
                raise ValueError(f"RenderConfig.{name} must be an integer >= {least}, got {value!r}")
        if self.oetf not in ("srgb", "pure_gamma"):
            raise ValueError(f"unknown oetf {self.oetf!r}")
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


def _shadow_pass(geometry: GeometryStatic, world_h, state, config: RenderConfig, active):
    """Depth-only rasters of the shadow-map slots (front-face culling,
    reverse-Z, depth bias). ``active`` ((n,) bool) says which of the first
    n slots anything samples; an inactive slot's raster is empty (the zero
    map), and the maps past n stay zero."""
    dim = config.shadow_dim
    d, s = state.directional_lights, state.spot_lights
    pv = torch.cat([matmul4(d.projection, d.view), matmul4(s.projection, s.view)], dim=0)
    maps = torch.zeros(
        (N_DIRECTIONAL + MAX_SPOT_LIGHTS, dim, dim), dtype=F32, device=world_h.device
    )
    tri_valid = geometry.tri_valid & geometry.tri_casts_shadow
    corners_world = world_h[geometry.triangles.long()]  # (T, 3, 4), gathered once
    for i in range(active.shape[0]):
        setup = setup_triangles(
            None, geometry.triangles, tri_valid & active[i], dim, dim,
            cull_keep_sign=-1,  # front-face culling (pipelines.cpp:654-663)
            corner_clip=matvec(pv[i], corners_world),
            depth_bias_constant=config.shadow_bias_constant,
            depth_bias_slope=config.shadow_bias_slope,
        )
        maps[i] = rasterize(setup, dim, dim, depth_only=True).depth
    return maps


def _geometry(geometry: GeometryStatic, params: FrameParams, config: RenderConfig, row0: int, local_rows: int):
    """The geometry stage (``_geometry_body``, ``frame.py:707-775``): frame
    state, vertex transforms, the shadow rasters of the maps anything
    samples, the camera raster of rows ``[row0, row0 + local_rows)`` and
    the G-buffer resolve. Returns (state, vis, gbuffer, shadow_maps,
    proj_view); the last feeds the shading stage."""
    state = prepare_frame_state(params)
    cam = state.camera
    proj_view = matmul4(cam.projection, cam.view)
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, proj_view
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
        grid_width=config.padded_width, grid_height=local_rows, grid_origin=(row0, 0),
    )
    vis = rasterize(setup, config.padded_width, local_rows, origin=(row0, 0))
    gbuffer = resolve_gbuffer(vis, setup, geometry, world, world_normals)
    return state, vis, gbuffer, shadow_maps, proj_view


def render_frame_linear(
    geometry: GeometryStatic, params: FrameParams, config: RenderConfig,
    row0: int = 0, local_rows: int | None = None,
):
    """Geometry + shading + debug lines: the pre-filter, pre-OETF color of
    rows ``[row0, row0 + local_rows)`` of the padded render target (the
    whole target by default), (rows, padded_width, 3). ``params`` holds
    tensors on the geometry's device (:func:`scene.pack.upload_frame_params`
    or :func:`scene.pack.unflatten_frame_params`)."""
    config.check()
    if config.debug_lines:
        raise ValueError("the plain frame draws no debug lines")
    local_rows = config.padded_height if local_rows is None else local_rows
    state, vis, gbuffer, shadow_maps, proj_view = _geometry(geometry, params, config, row0, local_rows)
    sun_shadow = None
    if config.share_sun_pcf and config.render_atmosphere:
        sun_shadow = _sun_pcf(state, gbuffer, shadow_maps, config)
    color = torch.clamp(
        deferred_lighting(
            gbuffer, state.camera, state.directional_lights, state.directional_count,
            state.directional_skip_count, state.spot_lights, state.spot_count, shadow_maps,
            shadowless_eps=config.shadowless_strength_eps, sun_shadow=sun_shadow, **_pcf_flags(config),
        ),
        0.0,
        1.0,
    )
    if config.render_atmosphere:
        color = _sky(state, color, vis.depth, gbuffer, shadow_maps, config, row0, sun_shadow)
    return color


def _pcf_flags(config: RenderConfig) -> dict:
    return dict(
        pcf_bitmask=config.pcf_bitmask, pcf_f16=config.pcf_f16, pcf_q8=config.pcf_q8,
        pcf_window2d=config.pcf_window2d,
    )


def _sun_pcf(state, gbuffer, shadow_maps, config: RenderConfig):
    """The sun's (H, W) PCF visibility that the lighting (directional
    light 0) and the sky pass both read (``share_sun_pcf``,
    ``frame.py:790-815``), evaluated once for the row block."""
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    return directional_pcf(
        sun, convert_pbr(gbuffer), shadow_maps[0], bitmask=config.pcf_bitmask, f16=config.pcf_f16,
        q8=config.pcf_q8, window2d=config.pcf_window2d,
    )


def _sky(state, lit, depth, gbuffer, shadow_maps, config: RenderConfig, row0: int, sun_shadow=None):
    """The atmosphere LUTs and the sky camera pass over the lit color
    (``_stage_sky``, ``frame.py:884-1055``) -> clamped (rows, W, 3).
    Every LUT is built from the f32 transmittance LUT; with ``lut_f16``
    the pass samples f16 copies of the transmittance LUT and the aerial
    volume, widened to f32 before filtering (``frame.py:938-955``)."""
    atmo, cam = state.atmosphere, state.camera
    t_lut = compute_transmittance_lut(atmo, config.transmittance_width, config.transmittance_height)
    zero = torch.zeros_like(atmo.planet_radius_mm)
    origin_mm = cam.position[:3] / METERS_PER_MM * constant(
        [1.0, -1.0, 1.0], F32, zero.device
    ) + torch.stack([zero, atmo.planet_radius_mm, zero])
    sky_arr = compute_skyview_lut(
        atmo, origin_mm, t_lut, config.skyview_width, config.skyview_height, fast=config.fast_sky
    )
    if config.skyview_q8:
        sky_lut = pack_lut_q8(sky_arr)
    else:
        sky_lut = sky_arr.to(torch.float16) if config.skyview_f16 else sky_arr
    tseg = aerial = None
    t_max_mm = config.aerial_lut_far_m / METERS_PER_MM
    if config.aerial_lut:
        if config.skyview_tseg:
            tseg = pack_tseg_rows(compute_skyview_tseg(atmo, t_lut, origin_mm, config.skyview_height))
        aerial = build_aerial_lut(atmo, t_lut, cam, origin_mm, t_max_mm)
    if config.lut_f16:
        t_lut = _f16_copy(t_lut)
        if aerial is not None:
            aerial = aerial._replace(volume=_f16_copy(aerial.volume))
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    color = sky_camera_pass(
        lit, depth, gbuffer, cam, atmo, t_lut, sky_lut, sun, shadow_maps[0],
        draw_extent=(config.render_width, config.render_height),
        aerial=aerial, aerial_t_max=t_max_mm, tseg_rows=tseg,
        metallic_reflection=config.metallic_reflection,
        row_origin=row0, fast=config.fast_sky, fast_reflection=config.fast_sky_reflection,
        sun_shadow=sun_shadow, **_pcf_flags(config),
    )
    return torch.clamp(color, 0.0, 1.0)


def _f16_copy(table):
    """A sampling copy rounded to f16 and widened back: the values the
    reference's f16 tables give its f32 filtering."""
    return table.to(torch.float16).to(F32)


def _encode(color, config: RenderConfig):
    """Supersample box filter, then the OETF (``frame.py:1070-1079``)."""
    ss = config.supersample
    if ss > 1:
        h = (color.shape[0] // ss) * ss
        w = (config.render_width // ss) * ss
        color = color[:h, :w].reshape(h // ss, ss, w // ss, ss, 3).mean(dim=(1, 3))
    return oetf_srgb(color) if config.oetf == "srgb" else oetf_pure_gamma(color)


def render_frame(geometry: GeometryStatic, params: FrameParams, config: RenderConfig):
    """Scene state -> (height, width, 3) nonlinear-encoded image in [0, 1],
    op by op on the geometry's device."""
    with torch.no_grad():
        encoded = _encode(render_frame_linear(geometry, params, config), config)
    return encoded[: config.height, : config.width]
