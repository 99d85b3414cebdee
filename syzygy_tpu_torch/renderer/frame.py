"""The frame graph: scene state to final image.

Port of ``syzygy_tpu/renderer/frame.py`` (``render_frame``,
``render_frame_packed``, ``render_frame_rows``) on one device:

1. geometry: frame state, vertex transforms, one depth raster per shadow
   map slot (empty where nothing samples it), the camera triangle setup + visibility
   raster, and the G-buffer resolve (per-triangle records, or the
   multi-gather form when the geometry has mips);
2. shading: deferred lighting (5x5 PCF on f16 maps); with the atmosphere
   the transmittance and sky-view LUTs and the sky camera pass, either
   over the t_seg and aerial LUTs (``aerial_lut``, the default) or with
   the quirk-exact per-pixel integrals;
3. the debug line overlay, the supersample box filter, the OETF and the
   crop.

The host enqueues a whole frame without waiting for the device, as the
reference's does (``frame.py:9-13``): light activity, shadow-map
activity and tile-list overflow are device tensors that the kernels and
masked sums read, and every size is static. On a CUDA device
:func:`render_frame` and :func:`render_frame_packed` therefore replay
each frame from a CUDA graph, captured once per (geometry, param spec,
config) after one eager frame; :func:`render_frame_eager` and
:func:`render_frame_rows` (which may hold collectives) stay eager, as does
every CPU frame.

The frame runs as contiguous layers (``renderer/layers.py``), each
a profiler range, the rasters' setup, binning and raster and the
G-buffer resolve parts inside theirs; a captured graph holds a stamp at
every layer and part boundary, so each replay writes its layers' and
parts' device times and its tile lists' counters (:func:`captured_frames`).

The TPU-only structure of the reference (three jitted programs, the
68-row ``lax.map`` sky chunks that dodge a TPU compiler crash, quad/joint
atlas packing, PCF segment tables) has no counterpart here; the storage
precisions that change results (f16 atlas, f16 or u8 PCF depths, q8
sky-view, f16 sampling copies of the sky's LUTs) are kept.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time

import numpy as np
import torch

from syzygy_tpu_torch.device import constant, to_tensor
from syzygy_tpu_torch.kernels.atmosphere import (
    METERS_PER_MM,
    compute_skyview_lut,
    compute_transmittance_lut,
    pack_lut_q8,
)
from syzygy_tpu_torch.kernels.debuglines import draw_lines
from syzygy_tpu_torch.kernels import build, lighting
from syzygy_tpu_torch.kernels.lighting import convert_pbr, deferred_lighting, directional_pcf, light_activity
from syzygy_tpu_torch.kernels.raster import TILE_H, TILE_W, bin_triangles, rasterize, setup_triangles
from syzygy_tpu_torch.kernels.resolve import (
    resolve_gbuffer,
    transform_normals,
    transform_positions,
)
from syzygy_tpu_torch.kernels.sky import (
    aerial_integrals_exact,
    build_aerial_lut,
    compute_skyview_tseg,
    pack_tseg_rows,
    sky_camera_pass,
)
from syzygy_tpu_torch.kernels.transfer import oetf_pure_gamma, oetf_srgb
from syzygy_tpu_torch.math.geometry import matmul4, matvec
from syzygy_tpu_torch.renderer.layers import FrameTrace, layer, part, recording, tally
from syzygy_tpu_torch.scene.lights import MAX_SPOT_LIGHTS
from syzygy_tpu_torch.scene.pack import (
    FrameParams,
    FrameParamSpec,
    GeometryStatic,
    param_leaves,
    prepare_frame_state,
    unflatten_frame_params,
)

N_DIRECTIONAL = 2  # sun + moon

F32 = torch.float32


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static frame configuration with the reference's field names and
    defaults (``frame.py:184-512``), each field honoured: the dimensions,
    shadow-map count/bias, LUT dims, ``pcf_f16``, ``pcf_q8``,
    ``shadowless_strength_eps``, ``share_sun_pcf``,
    ``skyview_q8``/``skyview_f16``, ``lut_f16``, ``skyview_tseg``,
    ``render_atmosphere``, ``debug_lines``, ``oetf``, ``supersample``,
    ``metallic_reflection``, ``aerial_lut`` and ``aerial_lut_far_m``,
    ``fast_sky`` and ``fast_sky_reflection`` (read by the
    per-pixel-integral sky only, as in the reference).
    ``shard_triangle_setup`` splits the camera setup and the resolve
    records over the row group of :func:`render_frame_rows` (``group=``).
    ``tile_list_capacity`` sizes the rasters' tile lists
    (``kernels/raster.py::bin_triangles``); lists that would drop a slot,
    and capacity 0, take the full-iteration raster, with the same bits.

    The reference's TPU scheduling fields (program fusion, sky row
    chunks, raster tile, chunk, unroll and vector settings) and its PCF
    gather layouts (``pcf_bitmask``, ``pcf_window2d``) have no
    counterpart here: the constructor refuses them."""

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
    pcf_f16: bool = True
    pcf_q8: bool = False
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
    fast_sky: bool = False
    aerial_lut: bool = True
    aerial_lut_far_m: float = 4000.0
    skyview_tseg: bool = True
    metallic_reflection: bool = True
    fast_sky_reflection: bool = True
    shard_triangle_setup: bool = True

    # sizes that must be positive (the reference editor's checks,
    # properties.py:289-295) or at least zero
    _POSITIVE = (
        "width", "height", "shadow_dim", "supersample", "skyview_width", "skyview_height",
        "transmittance_width", "transmittance_height",
    )
    _NON_NEGATIVE = ("n_shadow_maps", "tile_list_capacity")

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


def _shadow_pass(geometry: GeometryStatic, world_h, state, config: RenderConfig, active, group=None):
    """Depth-only rasters of the shadow-map slots (``frame.py:515-687``:
    front-face culling, reverse-Z, depth bias). ``active`` ((n,) bool on
    the device, :func:`kernels.lighting.light_activity`'s ``shadow_maps``)
    says which of the first n slots anything samples. Every one of them is
    rastered, its triangles valid only where its flag is set, so an
    inactive slot's raster is empty: the zero map, as the reference's
    inactive slots keep (``frame.py:614-618``); the maps past n stay zero.

    With a ``group`` of several ranks (``parallel.sharding.Group``) the
    slots are split over it statically (``frame.py:619-655``): each rank
    rasters a contiguous share of ``ceil(n / size)`` slots, so that every
    rank gathers the same shape, and the gathered maps go back to their
    slots."""
    dim = config.shadow_dim
    d, s = state.directional_lights, state.spot_lights
    pv = torch.cat([matmul4(d.projection, d.view), matmul4(s.projection, s.view)], dim=0)
    maps = torch.zeros(
        (N_DIRECTIONAL + MAX_SPOT_LIGHTS, dim, dim), dtype=F32, device=world_h.device
    )
    n = active.shape[0]
    if n == 0:
        return maps
    tri_valid = geometry.tri_valid & geometry.tri_casts_shadow
    corners_world = world_h[geometry.triangles.long()]  # (T, 3, 4), gathered once
    capacity = config.tile_list_capacity

    def raster_into(target, i):
        """Slot i's setup, binning and raster, its map copied to ``target``."""
        with part("shadow.setup"):
            setup = setup_triangles(
                None, geometry.triangles, tri_valid & active[i], dim, dim,
                cull_keep_sign=-1,  # front-face culling (pipelines.cpp:654-663)
                corner_clip=matvec(pv[i], corners_world),
                depth_bias_constant=config.shadow_bias_constant,
                depth_bias_slope=config.shadow_bias_slope,
            )
        lists = _binned("shadow", setup, dim, dim, capacity)
        with part("shadow.raster"):
            depth = rasterize(setup, dim, dim, depth_only=True, lists=lists, capacity=capacity).depth
            del lists  # freed before the copy, as when the raster binned inside itself
            target.copy_(depth)

    if group is None or group.size == 1:
        for i in range(n):
            raster_into(maps[i], i)
        return maps
    per = -(-n // group.size)
    local = torch.zeros((per, dim, dim), dtype=F32, device=world_h.device)
    for k, i in enumerate(range(group.index * per, min((group.index + 1) * per, n))):
        raster_into(local[k], i)
    maps[:n] = group.all_gather(local).reshape(-1, dim, dim)[:n]
    return maps


def _binned(layer_name: str, setup, width: int, height: int, capacity: int):
    """``setup``'s tile lists for a ``height x width`` target
    (:func:`kernels.raster.bin_triangles`) as the part ``<layer>.bin``,
    tallied into the frame's counters; None at capacity 0 (the raster
    then iterates over every slot)."""
    if not capacity:
        return None
    with part(f"{layer_name}.bin"):
        lists = bin_triangles(setup.coeffs, height, width, capacity)
        tally(lists)
    return lists


def _geometry(
    geometry: GeometryStatic, params: FrameParams, config: RenderConfig, row0: int, local_rows: int,
    group=None,
):
    """The geometry stage (``_geometry_body``, ``frame.py:707-775``): frame
    state, vertex transforms, the shadow rasters of the maps anything
    samples, the camera raster of rows ``[row0, row0 + local_rows)`` and
    the G-buffer resolve. Returns (state, vis, gbuffer, shadow_maps,
    proj_view); the last feeds the shading stage. ``group``
    splits the shadow rasters and, with ``config.shard_triangle_setup``,
    the camera setup and the resolve records over its ranks."""
    with layer("state"):
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
    with layer("shadow"):
        shadow_maps = _shadow_pass(geometry, world_h, state, config, activity.shadow_maps, group)
    setup_group = group if config.shard_triangle_setup else None

    with layer("gbuffer"):
        with part("gbuffer.setup"):
            setup = setup_triangles(
                clip, geometry.triangles, geometry.tri_valid,
                config.render_width, config.render_height,
                cull_keep_sign=+1,  # back-face cull, CW front (deferred.cpp:503-713)
                grid_width=config.padded_width, grid_height=local_rows, grid_origin=(row0, 0),
                group=setup_group,
            )
        capacity = config.tile_list_capacity
        lists = _binned("gbuffer", setup, config.padded_width, local_rows, capacity)
        with part("gbuffer.raster"):
            vis = rasterize(setup, config.padded_width, local_rows, origin=(row0, 0), lists=lists, capacity=capacity)
            del lists  # not held through the resolve
        with part("gbuffer.resolve"):
            gbuffer = resolve_gbuffer(vis, setup, geometry, world, world_normals, group=setup_group)
    return state, vis, gbuffer, shadow_maps, proj_view


def _stage_geometry(
    geometry: GeometryStatic, params: FrameParams, config: RenderConfig,
    row0: int = 0, local_rows: int | None = None,
):
    """The geometry stage alone (``frame.py:779``): (state, vis, gbuffer,
    shadow_maps), for inspecting the intermediate targets
    (``python -m syzygy_tpu_torch.app --dump-gbuffer``)."""
    config.check()
    local_rows = config.padded_height if local_rows is None else local_rows
    return _geometry(geometry, params, config, row0, local_rows)[:4]


def render_frame_linear(
    geometry: GeometryStatic, params: FrameParams, config: RenderConfig,
    row0: int = 0, local_rows: int | None = None, group=None,
):
    """Geometry + shading + debug lines: the pre-filter, pre-OETF color of
    rows ``[row0, row0 + local_rows)`` of the padded render target (the
    whole target by default), (rows, padded_width, 3). ``params`` holds
    tensors on the geometry's device (:func:`scene.pack.upload_frame_params`
    or :func:`scene.pack.unflatten_frame_params`). ``group``: as
    :func:`render_frame_rows`."""
    config.check()
    local_rows = config.padded_height if local_rows is None else local_rows
    state, vis, gbuffer, shadow_maps, proj_view = _geometry(
        geometry, params, config, row0, local_rows, group
    )
    with layer("lighting"):
        sun_shadow = None
        if config.share_sun_pcf and config.render_atmosphere:
            sun_shadow = _sun_pcf(state, gbuffer, shadow_maps, config)
        color = torch.clamp(
            deferred_lighting(
                gbuffer, state.camera, state.directional_lights, state.directional_count,
                state.directional_skip_count, state.spot_lights, state.spot_count, shadow_maps,
                pcf_f16=config.pcf_f16, pcf_q8=config.pcf_q8, shadowless_eps=config.shadowless_strength_eps,
                sun_shadow=sun_shadow,
            ),
            0.0,
            1.0,
        )
    if config.render_atmosphere:
        color = _sky(state, color, vis.depth, gbuffer, shadow_maps, config, row0, sun_shadow)
    if config.debug_lines:
        # the reference hands the overlay (width, height), not the render
        # extent, also under supersample > 1 (frame.py:1068): reproduced
        with layer("encode"):
            color = draw_lines(
                color, vis.depth, state.debug_segments, state.debug_valid, proj_view,
                (config.width, config.height),
            )
    return color


def _sun_pcf(state, gbuffer, shadow_maps, config: RenderConfig):
    """The sun's (H, W) PCF visibility that the lighting (directional
    light 0) and the sky pass both read (``share_sun_pcf``,
    ``frame.py:790-815``), evaluated once for the row block."""
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    return directional_pcf(sun, convert_pbr(gbuffer), shadow_maps[0], f16=config.pcf_f16, q8=config.pcf_q8)


def _sky(state, lit, depth, gbuffer, shadow_maps, config: RenderConfig, row0: int, sun_shadow=None):
    """The atmosphere LUTs and the sky camera pass over the lit color
    (``_stage_sky``, ``frame.py:884-1055``) -> clamped (rows, W, 3).
    Every LUT is built from the f32 transmittance LUT; with ``lut_f16``
    the pass samples f16 copies of the transmittance LUT and the aerial
    volume, widened to f32 before filtering (``frame.py:938-955``)."""
    atmo, cam = state.atmosphere, state.camera
    with layer("skyview_lut"):
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
    tseg = aerial = exact = None
    t_max_mm = config.aerial_lut_far_m / METERS_PER_MM
    draw_extent = (config.render_width, config.render_height)
    # without the aerial LUT, the f16 copy of the transmittance LUT counts
    # as the per-pixel integrals' layer, whose integrals sample it
    with layer("aerial_lut" if config.aerial_lut else "aerial_exact"):
        if config.aerial_lut:
            if config.skyview_tseg:
                tseg = pack_tseg_rows(compute_skyview_tseg(atmo, t_lut, origin_mm, config.skyview_height))
            aerial = build_aerial_lut(atmo, t_lut, cam, origin_mm, t_max_mm)
        if config.lut_f16:
            t_lut = _f16_copy(t_lut)
            if aerial is not None:
                aerial = aerial._replace(volume=_f16_copy(aerial.volume))
        if not config.aerial_lut:
            exact = aerial_integrals_exact(
                depth, gbuffer, cam, atmo, t_lut, draw_extent, config.metallic_reflection, row0,
                fast=config.fast_sky, fast_reflection=config.fast_sky_reflection,
            )
    with layer("sky_pass"):
        sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
        color = sky_camera_pass(
            lit, depth, gbuffer, cam, atmo, t_lut, sky_lut, sun, shadow_maps[0],
            draw_extent=draw_extent,
            aerial=aerial, aerial_t_max=t_max_mm, tseg_rows=tseg,
            metallic_reflection=config.metallic_reflection,
            row_origin=row0, fast=config.fast_sky, fast_reflection=config.fast_sky_reflection,
            pcf_f16=config.pcf_f16, pcf_q8=config.pcf_q8, sun_shadow=sun_shadow, exact=exact,
        )
        return torch.clamp(color, 0.0, 1.0)


def _f16_copy(table):
    """A sampling copy rounded to f16 and widened back: the values the
    reference's f16 tables give its f32 filtering."""
    return table.to(torch.float16).to(F32)


def _encode(color, config: RenderConfig):
    """Supersample box filter, then the OETF (``frame.py:1070-1079``)."""
    with layer("encode"):
        ss = config.supersample
        if ss > 1:
            h = (color.shape[0] // ss) * ss
            w = (config.render_width // ss) * ss
            color = color[:h, :w].reshape(h // ss, ss, w // ss, ss, 3).mean(dim=(1, 3))
        return oetf_srgb(color) if config.oetf == "srgb" else oetf_pure_gamma(color)


def render_frame_eager(geometry: GeometryStatic, params: FrameParams, config: RenderConfig):
    """:func:`render_frame` enqueued op by op, without a CUDA graph."""
    encoded = _encode(render_frame_linear(geometry, params, config), config)
    return encoded[: config.height, : config.width]


def render_frame(geometry: GeometryStatic, params: FrameParams, config: RenderConfig):
    """Scene state -> (height, width, 3) nonlinear-encoded image in [0, 1],
    on the geometry's device. On a CUDA device the frame is replayed from
    its CUDA graph (:func:`render_frame_packed`; ``params`` are packed
    into one f32 row on the device first, their integer and bool leaves
    exact), bitwise :func:`render_frame_eager`; params that require grad,
    and every CPU frame, render eagerly (a graph records no autograd)."""
    leaves = param_leaves(params)
    if geometry.positions.device.type != "cuda" or (
        torch.is_grad_enabled() and any(leaf.requires_grad for leaf in leaves)
    ):
        return render_frame_eager(geometry, params, config)
    spec = FrameParamSpec(
        tuple(tuple(leaf.shape) for leaf in leaves),
        tuple(str(leaf.dtype).removeprefix("torch.") for leaf in leaves),
        tuple(int(x) for x in np.cumsum([0] + [leaf.numel() for leaf in leaves[:-1]])),
        sum(leaf.numel() for leaf in leaves),
    )
    row = torch.cat([leaf.reshape(-1).to(F32) for leaf in leaves])
    return render_frame_packed(geometry, row, spec, config)


def render_frame_packed(geometry: GeometryStatic, buffer, spec: FrameParamSpec, config: RenderConfig):
    """:func:`render_frame` from a flattened FrameParams buffer
    (:func:`scene.pack.flatten_frame_params`), the leaves views of it on
    the geometry's device. ``buffer`` is the host's f32 numpy array, or an
    f32 tensor (a row of params that were uploaded together).

    On a CUDA device the call returns once the frame is enqueued: a numpy
    row goes through a pinned staging ring (``non_blocking``), and the
    frame replays from the CUDA graph of (geometry, spec, config),
    captured at the first call after one eager warm-up frame (which that
    call returns). The returned image is the caller's: later frames do not
    overwrite it. A failed capture or replay raises.

    Each replay's host spans ``stage`` (the copy into the graph's row,
    its wait on the ring slot included) and ``replay`` (the graph's
    launch), and its layer stamps, are kept by its graph
    (:func:`captured_frames`)."""
    device = geometry.positions.device
    if device.type != "cuda":
        buffer = buffer.to(device) if isinstance(buffer, torch.Tensor) else to_tensor(buffer, device)
        return render_frame_eager(geometry, unflatten_frame_params(spec, buffer), config)
    key = (id(geometry), spec, config)
    graph = _GRAPHS.get(key)
    if graph is None:
        config.check()
        row = torch.empty(spec.total, dtype=F32, device=device)
        _stage(buffer, row)
        graph, image = _FrameGraph.capture(geometry, row, spec, config)
        _GRAPHS[key] = graph
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
        return image
    _GRAPHS.move_to_end(key)
    return graph.replay(buffer)


GRAPH_CACHE_SIZE = 4  # captured frames kept, least recently used out first
STAGING_SLOTS = 2  # pinned rows per (device, size): a row in flight is never overwritten


class _FrameGraph:
    """One frame captured as a CUDA graph: its static input row, its
    output, the kernel launches it holds by kind, what its capture
    took, its :class:`layers.FrameTrace` (layer stamps in the graph, node
    counts, each replay's host spans) and the slot mask its lighting
    launch writes (:func:`kernels.lighting.last_slot_mask`)."""

    def __init__(self, graph, geometry, row, output, launches, capture_s, pool_bytes, trace, slot_mask):
        self.graph = graph
        self.geometry = geometry  # the graph reads its tensors: keep them alive
        self.row = row
        self.output = output
        self.launches = launches
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes
        self.trace = trace
        self.slot_mask = slot_mask

    @classmethod
    def capture(cls, geometry, row, spec, config):
        """One eager frame on the capture stream (it builds the kernels,
        makes the device constants and fills the allocator), then the
        frame captured from the same stream into a pool of its own, its
        layers stamped into the graph. Returns the graph and the eager
        frame."""
        device = row.device
        stream = _capture_stream(device)
        current = torch.cuda.current_stream(device)
        trace = FrameTrace(device, config.n_shadow_maps)  # on the stream that replays, outside the pool
        stream.wait_stream(current)
        with torch.no_grad(), torch.cuda.stream(stream):
            image = render_frame_eager(geometry, unflatten_frame_params(spec, row), config)
            reserved = torch.cuda.memory_reserved(device)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                with build.capture_record() as held, recording(trace):
                    output = render_frame_eager(geometry, unflatten_frame_params(spec, row), config)
            finally:
                graph.capture_end()
            capture_s = time.perf_counter() - t0
        current.wait_stream(stream)
        image.record_stream(current)
        pool = torch.cuda.memory_reserved(device) - reserved
        slot_mask = lighting.last_slot_mask(device) if held["lighting"] else None
        return cls(graph, geometry, row, output, held, capture_s, pool, trace, slot_mask), image

    def replay(self, buffer):
        """Stage ``buffer`` into the row and replay; keeps the host spans."""
        t0 = time.perf_counter()
        _stage(buffer, self.row)
        t1 = time.perf_counter()
        self.graph.replay()
        t2 = time.perf_counter()
        self.trace.replayed((t0, t1), (t1, t2))
        build.LAUNCHES.update(self.launches)
        return self.output.clone()


_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_CAPTURE_STREAMS: dict = {}
_STAGING: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _stage(buffer, row: torch.Tensor) -> None:
    """Copy a packed params row into ``row`` (on the card) without waiting
    for the stream: a device tensor directly, host data through the next
    slot of a pinned ring. The host waits only for that slot's previous
    copy, ``STAGING_SLOTS`` calls ago."""
    if isinstance(buffer, torch.Tensor) and buffer.device.type == "cuda":
        row.copy_(buffer)
        return
    host = np.asarray(buffer.numpy() if isinstance(buffer, torch.Tensor) else buffer, np.float32)
    if host.size != row.numel():
        raise ValueError(f"params row of {host.size} values, the spec holds {row.numel()}")
    key = (row.device, row.numel())
    if key not in _STAGING:
        slots = [torch.empty(row.numel(), dtype=F32, pin_memory=True) for _ in range(STAGING_SLOTS)]
        _STAGING[key] = [slots, [None] * STAGING_SLOTS, 0]
    ring = _STAGING[key]
    slots, events, k = ring
    ring[2] = (k + 1) % STAGING_SLOTS
    if events[k] is not None:
        events[k].synchronize()
    slots[k].numpy()[:] = host.reshape(-1)
    row.copy_(slots[k], non_blocking=True)
    events[k] = torch.cuda.Event()
    events[k].record(torch.cuda.current_stream(row.device))


def captured_frames() -> list[dict]:
    """What each cached CUDA graph holds: its config, the host seconds
    its capture took, the bytes its capture added to the device's
    reserved memory (its pool), its ``launches``: the kernel launches of
    each replay by kind (``kernels.build.LAUNCHES``' kinds, the layer
    stamps included), its ``layers`` in frame order, its ``parts`` and
    ``counters`` (``layers.PARTS`` and ``layers.COUNTERS`` that it writes),
    its ``nodes`` (each layer's, ``stamps``, ``part_stamps`` and ``total``),
    its ``replays`` so far, ``read``: a function that
    returns the finished replays' :class:`layers.Replay` records (layer
    device ms, part device ms, counters, host stage and replay ms), oldest
    first, once the frames are done, and ``lighting_slots``: a function that returns the light
    slots that the graph's lighting launch evaluated in its last replay
    (:func:`kernels.lighting.evaluated_slots`), None for a graph without
    one."""
    return [
        {
            "config": key[2], "capture_s": g.capture_s, "pool_bytes": g.pool_bytes, "launches": g.launches,
            "layers": list(g.trace.layers), "parts": list(g.trace.parts), "counters": list(g.trace.counters),
            "nodes": g.trace.nodes, "replays": g.trace.replays,
            "read": g.trace.read,
            "lighting_slots": functools.partial(lighting.evaluated_slots, g.slot_mask),
        }
        for key, g in _GRAPHS.items()
    ]


def render_frame_rows(
    geometry: GeometryStatic, params: FrameParams, config: RenderConfig, row0: int, local_rows: int,
    group=None,
):
    """Rows ``[row0, row0 + local_rows)`` of the padded frame, encoded,
    (local_rows / supersample, padded_width / supersample, 3), not cropped
    (``frame.py:1198-1234``): the same frame graph on a row block, so that
    stacked blocks are bitwise the whole padded frame. ``local_rows`` must
    be a multiple of the raster tile (and of ``supersample``). The shadow
    maps and LUTs are computed again per block. With a mip pyramid the
    first row of a block has no row above to difference against and takes
    the sharp level; the debug overlay is drawn in the block's own
    coordinates; both as in the reference.

    ``group`` (the reference's ``shadow_shard_axis``): a
    ``parallel.sharding.Group`` of the ranks that render this frame's row
    blocks, every one of them calling with its own block. The shadow
    rasters, and with ``config.shard_triangle_setup`` the camera setup and
    the resolve records, are split over it and rejoined with
    ``all_gather``, bitwise what one rank computes alone. None (the
    default) runs everything here."""
    if local_rows % TILE_H or row0 % TILE_H:
        raise ValueError(f"row block [{row0}, {row0 + local_rows}) is not a multiple of {TILE_H} rows")
    return _encode(render_frame_linear(geometry, params, config, row0, local_rows, group), config)
