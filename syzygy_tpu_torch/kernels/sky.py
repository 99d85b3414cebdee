"""Sky/ground/aerial-perspective camera pass (port of ``camera.comp``).

Port of ``syzygy_tpu/kernels/sky.py``, both formulations of
:func:`sky_camera_pass`:

* the aerial-LUT one (the reference's default,
  ``RenderConfig.aerial_lut=True``): geometry pixels trilinearly sample a
  32x32x16 froxel volume built with the exact in-scattering integral,
  environment pixels share one skyview and one transmittance sample across
  the ground/sky branches, and the ground branch's camera->surface
  transmittance comes from the per-row t_seg table;
* the quirk-exact one (``aerial=None``): one 32-step in-scattering
  integral per pixel over ``where(is_env, planet distance, surface
  distance)``, the unshared :func:`sample_environment` along the camera
  ray and, with the metallic bounce, a second one from the surface along
  the reflected ray. :func:`aerial_integrals_exact` computes both
  integrals (and the per-pixel rays and materials they need) ahead of the
  pass, which takes them as ``exact``; the frame enqueues them as a layer
  of their own (``renderer/layers.py``: ``aerial_exact``).

The aerial-LUT formulation takes one of two forms by its inputs' device:
on CUDA tensors :func:`sky_camera_pass` launches ``csrc/sky.cu``, one
thread per pixel, bitwise :func:`sky_camera_pass_lut_plain`, its frame
constants packed by :func:`sky_table`; on the CPU it runs
:func:`sky_camera_pass_lut_plain`. On the card, inputs that need a
gradient get the plain version's. ``kernels.build.LAUNCHES`` counts the
kernel's launches (``sky``). The quirk-exact formulation is tensor
operations on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from syzygy_tpu_torch.device import constant
from syzygy_tpu_torch.kernels import build
from syzygy_tpu_torch.kernels.atmosphere import (
    LUTQ8,
    METERS_PER_MM,
    PI,
    luminance_scattering_integral,
    luminance_scattering_integral_fast,
    ray_sphere_intersect,
    ray_sphere_intersect_fma,
    safe_sqrt,
    sample_lut_bilinear,
    sample_transmittance_ray,
    sample_transmittance_rmu,
    sample_transmittance_segment,
)
from syzygy_tpu_torch.kernels.lighting import (
    PCF_WINDOW_MAX_DIM,
    _TO_TEX_COORD,
    PBRTexel,
    _dot1,
    _normalize,
    compute_fresnel,
    convert_pbr,
    diffuse_brdf,
    directional_pcf,
    pixel_plane,
    q8_tables,
    specular_brdf,
)
from syzygy_tpu_torch.kernels.plain_gradient import dispatch
from syzygy_tpu_torch.kernels.resolve import GBuffer
from syzygy_tpu_torch.math.geometry import dot3_fma, fma32, matmul4, matvec, sqrt_rn, vec_norm
from syzygy_tpu_torch.scene.atmosphere import AtmospherePacked
from syzygy_tpu_torch.scene.camera import CameraPacked
from syzygy_tpu_torch.scene.lights import DirectionalLight

F32 = torch.float32


def _norm3(v):
    """``|v|`` over the last axis (kept), the squares summed as the
    reference's compiled fused multiply-add chain."""
    return sqrt_rn(torch.clamp(dot3_fma(v, v)[..., None], min=1e-20))


def _flip(device):
    return constant([1.0, -1.0, 1.0], F32, device)


def _lut_height(lut) -> int:
    return lut.scale.shape[0] if hasattr(lut, "scale") else lut.shape[0]


def _skyview_uv(atmo: AtmospherePacked, position, direction):
    """Direction -> skyview LUT (u, v), ``sampleMap_Direction``
    (``camera.comp:70-121``)."""
    normalized = direction / _norm3(direction)
    sin_horizon = atmo.planet_radius_mm / _norm3(position)[..., 0]
    horizon_zenith = PI - torch.asin(torch.clamp(sin_horizon, -1.0, 1.0))
    cos_view_zenith = normalized[..., 1]
    cos_horizon_zenith = -safe_sqrt(1.0 - sin_horizon * sin_horizon)
    view_zenith = torch.acos(torch.clamp(normalized[..., 1], -1.0, 1.0))
    above = cos_view_zenith > cos_horizon_zenith
    frac_above = view_zenith / torch.clamp(horizon_zenith, min=1e-12)
    v_above = (1.0 - safe_sqrt(1.0 - frac_above)) * 0.5
    frac_below = (view_zenith - horizon_zenith) / torch.clamp(PI - horizon_zenith, min=1e-12)
    v_below = safe_sqrt(frac_below) * 0.5 + 0.5
    v = torch.where(above, v_above, v_below)

    light_proj = _light_proj(atmo)
    view_proj = torch.stack([direction[..., 0], direction[..., 2]], dim=-1)
    view_proj = view_proj / torch.clamp(
        vec_norm(view_proj, dim=-1, keepdim=True), min=1e-12
    )
    u = (
        torch.clamp(light_proj[0] * view_proj[..., 0] + light_proj[1] * view_proj[..., 1], -1.0, 1.0)
        * 0.5
        + 0.5
    )
    return u, v


def _light_proj(atmo: AtmospherePacked):
    """The sun's azimuth in the sky-view LUT: (-sun.x, -sun.z), normalized."""
    sun = atmo.incident_direction_sun
    light_proj = -torch.stack([sun[0], sun[2]])
    return light_proj / torch.clamp(vec_norm(light_proj), min=1e-12)


def sample_skyview(atmo: AtmospherePacked, skyview_lut, position, direction):
    """``sampleMap_Direction`` (``camera.comp:70-121``)."""
    u, v = _skyview_uv(atmo, position, direction)
    return sample_lut_bilinear(skyview_lut, u, v)


def sample_skyview_ground(atmo: AtmospherePacked, skyview_lut, position, direction):
    """Skyview sample for a planet-hitting ray (``sky.py:87-102``): v is
    clamped so both bilinear rows lie in the below-horizon half."""
    u, v = _skyview_uv(atmo, position, direction)
    return sample_lut_bilinear(
        skyview_lut, u, torch.clamp(v, min=0.5 + 0.5 / _lut_height(skyview_lut))
    )


def sample_sun_disk(atmo, transmittance_lut, position, direction):
    """``sampleSunDisk`` (``camera.comp:123-140``)."""
    transmittance = sample_transmittance_ray(transmittance_lut, atmo, position, direction)
    return _sun_disk(atmo, direction, transmittance)


def _sun_disk(atmo, direction, transmittance):
    to_sun = -atmo.incident_direction_sun
    cos_dir_sun = torch.sum(direction * to_sun, dim=-1) / (
        _norm3(direction)[..., 0] * vec_norm(to_sun)
    )
    sin_sun_radius = atmo.sun_angular_radius
    sin_dir_sun = safe_sqrt(1.0 - cos_dir_sun * cos_dir_sun)
    edge0 = 0.2 * sin_sun_radius
    t = torch.clamp((sin_dir_sun - edge0) / torch.clamp(sin_sun_radius - edge0, min=1e-12), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    disk = transmittance * (1.0 - smooth)[..., None]
    return torch.where((cos_dir_sun < 0.0)[..., None], 0.0, disk)


def fraction_of_sun_visible(atmo, radius):
    """``computeFractionOfSunVisible`` (``camera.comp:142-147``): the
    reference early-returns sinHorizonZenith; reproduced."""
    return atmo.planet_radius_mm / radius


def _hit_planet(atmo, origin, direction):
    hit, t0, _ = ray_sphere_intersect(origin, direction, atmo.planet_radius_mm)
    return hit & (t0 > 0.0), t0


def _hit_planet_fma(atmo, origin, direction):
    """:func:`_hit_planet` with the compiled sky pass's arithmetic
    (:func:`ray_sphere_intersect_fma`)."""
    hit, t0, _ = ray_sphere_intersect_fma(origin, direction, atmo.planet_radius_mm)
    return hit & (t0 > 0.0), t0


def _ground_albedo_nl(atmo, surface, direction):
    """The ground's BRDF times n.l (``sampleGround``,
    ``camera.comp:203-235``), with the reference's compiled dot products:
    the glint's power of 160 amplifies each rounding of them."""
    light_dir = -atmo.incident_direction_sun
    surface_normal = surface / _norm3(surface)
    halfway = light_dir + (-direction)
    halfway = halfway / _norm3(halfway)
    ld_b = light_dir.expand(halfway.shape)
    spec_power = 160.0
    microfacet = torch.pow(torch.clamp(dot3_fma(halfway, surface_normal)[..., None], 0.0, 1.0), spec_power)
    specular = (spec_power + 2.0) / 8.0 * microfacet
    diffuse = 0.4 / PI
    fresnel = 0.04 + (1.0 - 0.04) * torch.pow(
        1.0 - torch.clamp(dot3_fma(halfway, ld_b)[..., None], 0.0, 1.0), 5.0
    )
    albedo = diffuse * (1.0 - fresnel) + specular * fresnel
    nl = torch.clamp(dot3_fma(surface_normal, ld_b)[..., None], 0.0, 1.0)
    return albedo, nl


def _integral(fast: bool):
    return luminance_scattering_integral_fast if fast else luminance_scattering_integral


def sample_ground(atmo, transmittance_lut, origin, direction, dist, aerial=None, fast: bool = False):
    """``sampleGround`` (``camera.comp:203-235``, ``sky.py:139-178``).
    ``aerial`` injects a precomputed in-scattering integral for the same
    (origin, direction, dist)."""
    surface = fma32(dist[..., None], direction, origin)
    albedo, nl = _ground_albedo_nl(atmo, surface, direction)
    light_dir = -atmo.incident_direction_sun
    t_sun = sample_transmittance_ray(
        transmittance_lut, atmo, surface, light_dir.expand(surface.shape)
    )
    surface_lum = t_sun * albedo * nl
    t_surface = sample_transmittance_segment(transmittance_lut, atmo, origin, surface)
    if aerial is None:
        aerial = _integral(fast)(atmo, transmittance_lut, origin, direction, dist)
    return surface_lum * t_surface + aerial


def sample_environment(
    atmo, transmittance_lut, skyview_lut, position, direction,
    hit_dist=None, aerial=None, fast: bool = False,
):
    """``sampleEnvironmentLuminanceTransfer`` (``camera.comp:286-301``,
    ``sky.py:181-199``) -> (luminance, sun disk); the sun's shadow factor
    multiplies only the disk at the call sites."""
    hit, dist = _hit_planet_fma(atmo, position, direction) if hit_dist is None else hit_dist
    ground = sample_ground(atmo, transmittance_lut, position, direction, dist, aerial=aerial, fast=fast)
    sky = sample_skyview(atmo, skyview_lut, position, direction)
    disk = sample_sun_disk(atmo, transmittance_lut, position, direction)
    hit3 = hit[..., None]
    return torch.where(hit3, ground, sky), torch.where(hit3, 0.0, disk)


def compute_skyview_tseg(atmo, transmittance_lut, position, height: int):
    """Per-row camera->planet-surface segment transmittance over the skyview
    v axis, (height, 3) (``sky.py:202-238``). Rows above the horizon hold 1."""
    dev = position.device
    r = sqrt_rn(torch.clamp(torch.sum(position * position), min=1e-20))
    sin_horizon = torch.clamp(atmo.planet_radius_mm / r, -1.0, 1.0)
    horizon_zenith = PI - torch.asin(sin_horizon)
    v = (torch.arange(height, dtype=F32, device=dev) + 0.5) / height
    vz_below = horizon_zenith + torch.square((v - 0.5) * 2.0) * (PI - horizon_zenith)
    vz_above = (1.0 - torch.square(1.0 - 2.0 * v)) * horizon_zenith
    view_zenith = torch.where(v >= 0.5, vz_below, vz_above)
    direction = torch.stack(
        [torch.sin(view_zenith), torch.cos(view_zenith), torch.zeros_like(v)], dim=-1
    )
    pos_axis = torch.stack([torch.zeros_like(r), r, torch.zeros_like(r)]).expand(direction.shape)
    hit, dist = _hit_planet(atmo, pos_axis, direction)
    surface = pos_axis + dist[..., None] * direction
    t_seg = sample_transmittance_segment(transmittance_lut, atmo, pos_axis, surface)
    return torch.where(hit[..., None], t_seg, 1.0)


def pack_tseg_rows(rows: torch.Tensor) -> torch.Tensor:
    """(h, 3) rows -> (h, 6) pairs ``[t(y), t(y+1)]`` (edge-clamped)."""
    h = rows.shape[0]
    yd = torch.clamp(torch.arange(h, device=rows.device) + 1, max=h - 1)
    return torch.cat([rows, rows[yd]], dim=-1)


def _sample_tseg_rows(packed, v):
    """v-only linear sample with the bilinear sampler's v->row mapping."""
    h = packed.shape[0]
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    fy = (y - y0)[..., None]
    q = packed[y0]
    return q[..., 0:3] * (1 - fy) + q[..., 3:6] * fy


def sample_environment_shared(atmo, transmittance_lut, skyview_lut, position, direction, tseg_rows=None):
    """``sampleEnvironmentLuminanceTransfer`` (``camera.comp:286-301``) with
    the ground (planet hit) and sky (miss) branches sharing one skyview and
    one transmittance sample (``sky.py:264-362``) -> (luminance, sun disk)."""
    # the planet hit and the glint's dot products with the reference's
    # compiled arithmetic: the ground's glint (specular power 160) and its
    # planet hit near the horizon amplify each rounding of these, so plain
    # forms miss the reference by more than the pass's tolerance there
    hit, dist, _ = ray_sphere_intersect_fma(position, direction, atmo.planet_radius_mm)
    hit = hit & (dist > 0.0)
    surface = fma32(dist[..., None], direction, position)

    h = _lut_height(skyview_lut)
    u, v = _skyview_uv(atmo, position, direction)
    v_sel = torch.where(hit, torch.clamp(v, min=0.5 + 0.5 / h), v)
    sky = sample_lut_bilinear(skyview_lut, u, v_sel)

    light_dir = -atmo.incident_direction_sun
    ld_b = light_dir.expand(surface.shape)
    r_srf = _norm3(surface)[..., 0]
    mu_srf = torch.sum(surface * ld_b, dim=-1) / (r_srf * _norm3(ld_b)[..., 0])
    r_ray = _norm3(position)[..., 0]
    mu_ray = torch.sum(position * direction, dim=-1) / (r_ray * _norm3(direction)[..., 0])
    t_shared = sample_transmittance_rmu(
        transmittance_lut, atmo, torch.where(hit, r_srf, r_ray), torch.where(hit, mu_srf, mu_ray)
    )

    # ground shading (sampleGround, camera.comp:203-235)
    albedo, nl = _ground_albedo_nl(atmo, surface, direction)
    surface_lum = t_shared * albedo * nl
    if tseg_rows is not None:
        t_surface = _sample_tseg_rows(tseg_rows, v_sel)
    else:
        t_surface = sample_transmittance_segment(transmittance_lut, atmo, position, surface)
    ground = surface_lum * t_surface + sky

    # sun disk (sampleSunDisk, camera.comp:123-140)
    disk = _sun_disk(atmo, direction, t_shared)
    hit3 = hit[..., None]
    return torch.where(hit3, ground, sky), torch.where(hit3, 0.0, disk)


def geometry_luminance_transfer(
    atmo, transmittance_lut, direction, material: PBRTexel, shadow_factor,
    aerial, t_surface=None, t_sun=None, origin=None,
):
    """``computeGeometryLuminanceTransfer`` (``camera.comp:237-278``,
    ``sky.py:365-409``). ``t_surface``/``t_sun`` inject the camera->surface
    and surface->sun transmittances (the froxel volume stores both);
    without them they are sampled per pixel, the first from ``origin``."""
    surface = material.position
    light_dir = _normalize(-atmo.incident_direction_sun)
    if t_surface is None:
        t_surface = sample_transmittance_segment(transmittance_lut, atmo, origin, surface)
    if t_sun is None:
        t_sun = sample_transmittance_ray(
            transmittance_lut, atmo, surface, light_dir.expand(surface.shape)
        )
    view_dir = -direction / _norm3(direction)
    shadowed_by_planet, _ = _hit_planet(atmo, surface, light_dir.expand(surface.shape))
    fresnel = compute_fresnel(material, light_dir, view_dir)
    # fractionOfSunVisible early-returns sinHorizonZenith (camera.comp:147)
    frac_visible = fraction_of_sun_visible(atmo, _norm3(surface)[..., 0])
    nl = torch.clamp(_dot1(material.normal, light_dir), 0.0, 1.0)
    surface_transfer = (
        shadow_factor[..., None]
        * frac_visible[..., None]
        * (~shadowed_by_planet)[..., None].to(F32)
        * t_sun
        * t_surface
        * material.occlusion
        * (diffuse_brdf(material) * (1.0 - fresnel) + specular_brdf(material, light_dir, view_dir) * fresnel)
        * nl
    )
    return surface_transfer + aerial


def reflect_direction(normal, outgoing):
    """``reflectDirection`` (``camera.comp:280-284``)."""
    return 2.0 * (_dot1(normal, outgoing) * normal) - outgoing


class AerialLUT(NamedTuple):
    """Froxel volume of :func:`build_aerial_lut`: ``volume`` (n_y, n_x,
    n_s, 9) = (in-scatter rgb, path transmittance rgb, sun transmittance
    rgb); ``t_sun0`` (3,) = sun transmittance at the camera."""

    volume: torch.Tensor
    t_sun0: torch.Tensor


def build_aerial_lut(atmo, transmittance_lut, camera: CameraPacked, origin_mm, t_max_mm: float,
                     n_x: int = 32, n_y: int = 32, n_slices: int = 16) -> AerialLUT:
    """Camera-frustum aerial-perspective volume (``sky.py:423-516``): the
    exact in-scattering integral along the ray through screen point
    ((x+.5)/n_x, (y+.5)/n_y) to distance ((j+1)/n_slices)^2 * t_max. All
    slices run as one batch (the integral is elementwise per ray)."""
    dev = origin_mm.device
    xs = ((torch.arange(n_x, dtype=F32, device=dev) + 0.5) / n_x - 0.5) * 2.0
    ys = ((torch.arange(n_y, dtype=F32, device=dev) + 0.5) / n_y - 0.5) * 2.0
    clip_uv = torch.stack(
        [xs[None, :].expand(n_y, n_x), ys[:, None].expand(n_y, n_x)], dim=-1
    )
    ones = torch.ones((n_y, n_x, 1), dtype=F32, device=dev)
    view_h = matvec(camera.inverse_projection, torch.cat([clip_uv, ones, ones], dim=-1))
    direction = matvec(camera.rotation, view_h)[..., :3]
    direction = direction / _norm3(direction)
    direction = direction * _flip(dev)

    fracs = ((torch.arange(n_slices, dtype=F32, device=dev) + 1.0) / n_slices) ** 2
    light_dir = _normalize(-atmo.incident_direction_sun)
    shape = (n_slices, n_y, n_x, 3)
    origin = origin_mm.expand(shape)
    direction_s = direction.expand(shape)
    dist = (fracs * t_max_mm)[:, None, None].expand(n_slices, n_y, n_x)
    lum = luminance_scattering_integral(atmo, transmittance_lut, origin, direction_s, dist)
    slice_pos = origin + dist[..., None] * direction_s
    t_seg = sample_transmittance_segment(transmittance_lut, atmo, origin, slice_pos)
    t_sun = sample_transmittance_ray(transmittance_lut, atmo, slice_pos, light_dir.expand(shape))
    volume = torch.cat([lum, t_seg, t_sun], dim=-1).permute(1, 2, 0, 3).contiguous()
    t_sun0 = sample_transmittance_ray(transmittance_lut, atmo, origin_mm, light_dir)
    return AerialLUT(volume, t_sun0)


def sample_aerial_lut(aerial: AerialLUT, uv, dist_mm, t_max_mm: float):
    """Trilinear sample at screen uv and ray distance (``sky.py:544-595``)
    -> (in-scatter, path T, sun T). Clamp-to-edge; distances short of the
    first slice lerp toward the implicit distance-0 slice (no in-scatter,
    path T = 1, sun T = t_sun0)."""
    vol = aerial.volume
    n_y, n_x, n_s = vol.shape[0], vol.shape[1], vol.shape[2]
    x = torch.clamp(uv[..., 0] * n_x - 0.5, 0.0, n_x - 1.0)
    y = torch.clamp(uv[..., 1] * n_y - 0.5, 0.0, n_y - 1.0)
    s = torch.clamp(sqrt_rn(torch.clamp(dist_mm, min=0.0) / t_max_mm) * n_s - 1.0, -1.0, n_s - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    s0f = torch.floor(s)
    s0 = torch.clamp(s0f, min=-1.0).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    fs = (s - s0f)[..., None]
    x1 = torch.clamp(x0 + 1, max=n_x - 1)
    y1 = torch.clamp(y0 + 1, max=n_y - 1)
    sa = torch.clamp(s0, min=0)
    sb = torch.clamp(sa + 1, max=n_s - 1)

    def bilin(si):
        top = vol[y0, x0, si] * (1 - fx) + vol[y0, x1, si] * fx
        bot = vol[y1, x0, si] * (1 - fx) + vol[y1, x1, si] * fx
        return top * (1 - fy) + bot * fy

    b0 = bilin(sa)
    b1 = bilin(sb)
    zero_slice = torch.cat(
        [torch.zeros_like(b0[..., 0:3]), torch.ones_like(b0[..., 3:6]), aerial.t_sun0.expand(b0[..., 6:9].shape)],
        dim=-1,
    )
    out = torch.where(
        (s0 < 0)[..., None], zero_slice * (1.0 - fs) + b0 * fs, b0 * (1.0 - fs) + b1 * fs
    )
    return out[..., 0:3], out[..., 3:6], out[..., 6:9]


def _sky_position(camera: CameraPacked, atmo: AtmospherePacked):
    """The camera's position, engine (+y down, meters) -> sky space (+y up,
    Mm) (``camera.comp:318-322``)."""
    up_r = torch.stack([torch.zeros_like(atmo.planet_radius_mm), atmo.planet_radius_mm,
                        torch.zeros_like(atmo.planet_radius_mm)])
    return camera.position[:3] / METERS_PER_MM * _flip(up_r.device) + up_r


def camera_rays(camera: CameraPacked, atmo: AtmospherePacked, h: int, w: int,
                draw_extent: tuple[int, int], row_origin: int = 0):
    """The pass's per-pixel view rays in sky space (+y up, Mm) for rows
    ``[row_origin, row_origin + h)`` (``camera.comp:318-328``) ->
    (position (3,), direction (h, w, 3), xs (1, w), ys (h, 1)), xs/ys the
    centred clip coordinates in [-1, 1)."""
    dev = camera.position.device
    draw_w, draw_h = draw_extent
    flip = _flip(dev)
    position = _sky_position(camera, atmo)

    # per-pixel view ray (camera.comp:324-328). The reference's compiled
    # ``i / extent - 0.5`` is ``fma(i, 1 / extent, -0.5)`` (division by a
    # constant becomes a reciprocal multiply, then contracts); exact for
    # power-of-two extents, one rounding fewer otherwise.
    def centred(i, extent):
        inv = torch.full((), 1.0 / extent, dtype=F32, device=dev)
        return (i.double() * inv.double() - 0.5).float() * 2.0

    xs = centred(torch.arange(w, dtype=F32, device=dev)[None, :], draw_w)
    rows = torch.arange(h, dtype=F32, device=dev) + float(row_origin)
    ys = centred(rows[:, None], draw_h)
    clip_uv = torch.stack([xs.expand(h, w), ys.expand(h, w)], dim=-1)
    ones = torch.ones((h, w, 1), dtype=F32, device=dev)
    view_h = matvec(camera.inverse_projection, torch.cat([clip_uv, ones, ones], dim=-1))
    direction = matvec(camera.rotation, view_h)[..., :3]
    direction = direction / _norm3(direction)
    return position, direction * flip, xs, ys


def _transfers_aerial(
    atmo, transmittance_lut, skyview_lut, pos_grid, direction, sky_material, is_env,
    dist_surface, sun_shadow, xs, ys, aerial, aerial_t_max, tseg_rows, metallic_reflection,
):
    """(environment, geometry) luminance transfers of the aerial-LUT
    formulation (``sky.py:705-760``)."""
    h, w = is_env.shape
    uv = torch.stack([(xs * 0.5 + 0.5).expand(h, w), (ys * 0.5 + 0.5).expand(h, w)], dim=-1)
    geom_aerial, geom_t_surface, geom_t_sun = sample_aerial_lut(aerial, uv, dist_surface, aerial_t_max)
    # branch-shared environment sampling: the camera ray for environment
    # pixels, the reflected ray from the surface for the metallic bounce
    if metallic_reflection:
        refl_dir = reflect_direction(sky_material.normal, -direction)
        env_mask = is_env[..., None]
        es_pos = torch.where(env_mask, pos_grid, sky_material.position)
        es_dir = torch.where(env_mask, direction, refl_dir)
    else:
        es_pos, es_dir = pos_grid, direction
    env, disk = sample_environment_shared(atmo, transmittance_lut, skyview_lut, es_pos, es_dir, tseg_rows)
    env_transfer = env + disk  # shadowFactor = 1 on the environment branch

    geo_transfer = geometry_luminance_transfer(
        atmo, transmittance_lut, direction, sky_material, sun_shadow,
        aerial=geom_aerial, t_surface=geom_t_surface, t_sun=geom_t_sun,
    )
    if metallic_reflection:
        refl = env + disk * sun_shadow[..., None]
        geo_transfer = geo_transfer + (
            geom_t_surface * sky_material.metallic
            * compute_fresnel(sky_material, -direction, refl_dir) * refl
        )

    return env_transfer, geo_transfer


class SkyPixels(NamedTuple):
    """The sky pass's per-pixel inputs (``camera.comp:303-328``): the
    camera ``position`` (3,) and view ``direction`` (h, w, 3) in sky space
    (+y up, Mm), the centred clip coordinates ``xs`` (1, w) and ``ys``
    (h, 1), the G-buffer's ``material`` in engine space and
    ``sky_material`` in sky space, ``pos_grid`` (the position broadcast
    over the pixels), ``is_env`` (no geometry, or geometry below the
    ground) and ``dist_surface`` (camera to surface, Mm)."""

    position: torch.Tensor
    direction: torch.Tensor
    xs: torch.Tensor
    ys: torch.Tensor
    material: PBRTexel
    sky_material: PBRTexel
    pos_grid: torch.Tensor
    is_env: torch.Tensor
    dist_surface: torch.Tensor


def sky_pixels(scene_depth, gbuffer: GBuffer, camera: CameraPacked, atmo: AtmospherePacked,
               draw_extent: tuple[int, int], row_origin: int = 0) -> SkyPixels:
    """:class:`SkyPixels` of rows ``[row_origin, row_origin + h)``."""
    h, w = scene_depth.shape
    flip = _flip(scene_depth.device)
    position, direction, xs, ys = camera_rays(camera, atmo, h, w, draw_extent, row_origin)
    zero = torch.zeros_like(atmo.planet_radius_mm)
    up_r = torch.stack([zero, atmo.planet_radius_mm, zero])

    material = convert_pbr(gbuffer)
    sky_material = material._replace(
        normal=material.normal * flip,
        position=material.position * flip / METERS_PER_MM + up_r,
    )
    pos_grid = position.expand(direction.shape)
    is_env = (scene_depth == 0.0) | (material.position[..., 1] > 0.0)
    dist_surface = vec_norm(sky_material.position - pos_grid)
    return SkyPixels(position, direction, xs, ys, material, sky_material, pos_grid, is_env, dist_surface)


class ExactAerial(NamedTuple):
    """The quirk-exact formulation's in-scattering integrals
    (:func:`aerial_integrals_exact`): the ``pixels`` they were taken over,
    the camera ray's ``planet`` hit (hit, distance), the ``shared``
    integral (h, w, 3) and, with the metallic bounce, ``bounce``: the
    reflected direction, its planet hit from the surface and its
    integral (None without the bounce)."""

    pixels: SkyPixels
    planet: tuple
    shared: torch.Tensor
    bounce: tuple | None


def aerial_integrals_exact(
    scene_depth, gbuffer: GBuffer, camera: CameraPacked, atmo: AtmospherePacked, transmittance_lut,
    draw_extent: tuple[int, int], metallic_reflection: bool = True, row_origin: int = 0,
    fast: bool = False, fast_reflection: bool = False,
) -> ExactAerial:
    """The per-pixel in-scattering integrals of the quirk-exact sky pass
    (``camera.comp:274-277, 379-387``, ``common.glinl:363-424``): the
    pixels are exclusively environment or geometry, so one 32-step
    integral over ``where(is_env, planet distance, surface distance)``
    serves both branches; with ``metallic_reflection`` the bounce's
    environment integral from the surface along the reflected ray, with
    the exp-step integral when ``fast or fast_reflection``. The pass
    (:func:`sky_camera_pass` ``exact=``) reads them as they are."""
    pixels = sky_pixels(scene_depth, gbuffer, camera, atmo, draw_extent, row_origin)
    pos_grid, direction, sky_material = pixels.pos_grid, pixels.direction, pixels.sky_material
    hit, dist_planet = _hit_planet_fma(atmo, pos_grid, direction)
    shared_dist = torch.where(pixels.is_env, dist_planet, pixels.dist_surface)
    shared = _integral(fast)(atmo, transmittance_lut, pos_grid, direction, shared_dist)
    bounce = None
    if metallic_reflection:  # the ad-hoc single bounce (camera.comp:379-387)
        refl_dir = reflect_direction(sky_material.normal, -direction)
        refl_hit = _hit_planet_fma(atmo, sky_material.position, refl_dir)
        refl_aerial = _integral(fast or fast_reflection)(
            atmo, transmittance_lut, sky_material.position, refl_dir, refl_hit[1]
        )
        bounce = (refl_dir, refl_hit, refl_aerial)
    return ExactAerial(pixels, (hit, dist_planet), shared, bounce)


def _transfers_exact(atmo, transmittance_lut, skyview_lut, exact: ExactAerial, sun_shadow):
    """(environment, geometry) luminance transfers of the quirk-exact
    formulation (``sky.py:761-809``) over the integrals of ``exact``."""
    pixels = exact.pixels
    pos_grid, direction, sky_material = pixels.pos_grid, pixels.direction, pixels.sky_material
    env, disk = sample_environment(
        atmo, transmittance_lut, skyview_lut, pos_grid, direction,
        hit_dist=exact.planet, aerial=exact.shared,
    )
    env_transfer = env + disk  # shadowFactor = 1 on the environment branch
    geo_transfer = geometry_luminance_transfer(
        atmo, transmittance_lut, direction, sky_material, sun_shadow,
        aerial=exact.shared, origin=pos_grid,
    )
    if exact.bounce is not None:  # the ad-hoc single bounce (camera.comp:379-387)
        t_surface = sample_transmittance_segment(
            transmittance_lut, atmo, pos_grid, sky_material.position
        )
        refl_dir, refl_hit, refl_aerial = exact.bounce
        refl_env, refl_disk = sample_environment(
            atmo, transmittance_lut, skyview_lut, sky_material.position, refl_dir,
            hit_dist=refl_hit, aerial=refl_aerial,
        )
        refl = refl_env + refl_disk * sun_shadow[..., None]
        geo_transfer = geo_transfer + (
            t_surface * sky_material.metallic
            * compute_fresnel(sky_material, -direction, refl_dir) * refl
        )
    return env_transfer, geo_transfer


def _composite(is_env, env_transfer, geo_transfer, scene_color, atmo):
    """The pass's tonemapped colour (``camera.comp:389-395``): the branch's
    transfer times the sun's spectrum, times 10, plus the lit colour of
    geometry pixels, to the power 1.2."""
    env3 = is_env[..., None]
    transfer = torch.where(env3, env_transfer, geo_transfer)
    surface_luminance = torch.where(env3, 0.0, scene_color)
    luminance = transfer * atmo.sun_intensity_spectrum
    return torch.pow(torch.clamp(luminance * 10.0 + surface_luminance, min=0.0), 1.2)


def sky_camera_pass_lut_plain(
    scene_color, scene_depth, gbuffer: GBuffer, camera: CameraPacked, atmo: AtmospherePacked, transmittance_lut,
    skyview_lut, sun_light: DirectionalLight, sun_shadow_map, aerial: AerialLUT, tseg_rows, sun_shadow,
    draw_extent: tuple[int, int], aerial_t_max: float, metallic_reflection: bool, pcf_f16: bool, pcf_q8: bool,
    row_origin: int,
):
    """The aerial-LUT formulation of :func:`sky_camera_pass` in tensor
    operations over the whole block."""
    pixels = sky_pixels(scene_depth, gbuffer, camera, atmo, draw_extent, row_origin)
    if sun_shadow is None:
        sun_shadow = directional_pcf(sun_light, pixels.material, sun_shadow_map, f16=pcf_f16, q8=pcf_q8)
    env_transfer, geo_transfer = _transfers_aerial(
        atmo, transmittance_lut, skyview_lut, pixels.pos_grid, pixels.direction, pixels.sky_material,
        pixels.is_env, pixels.dist_surface, sun_shadow, pixels.xs, pixels.ys, aerial, aerial_t_max,
        tseg_rows, metallic_reflection,
    )
    return _composite(pixels.is_env, env_transfer, geo_transfer, scene_color, atmo)


SKY_TABLE = 69  # f32 values of :func:`sky_table` (csrc/sky.cu)
SKY_F32, SKY_F16, SKY_Q8 = 0, 1, 2  # the kernel's sky-view LUT formats


def sky_table(camera: CameraPacked, atmo: AtmospherePacked, sun_light: DirectionalLight,
              aerial: AerialLUT) -> torch.Tensor:
    """What the kernel reads of the frame, (SKY_TABLE,) f32 on the
    camera's device: the camera's ``inverse_projection`` and ``rotation``
    (16 each, row-major) and its position in sky space, the planet's and
    the atmosphere's radii, ``incident_direction_sun``, the sky-view's
    light projection, ``_normalize(-sun)``, ``vec_norm(-sun)``,
    ``sun_angular_radius``, ``sun_intensity_spectrum``, the sun's shadow
    frame ``matmul4(_TO_TEX_COORD, matmul4(projection, view))`` (16,
    row-major) and the aerial LUT's ``t_sun0``. Each value is bitwise the
    one the plain version computes, by its own tensor operation."""
    dev = camera.position.device
    sun = atmo.incident_direction_sun
    frame = matmul4(constant(_TO_TEX_COORD, F32, dev), matmul4(sun_light.projection, sun_light.view))
    parts = [
        camera.inverse_projection.reshape(16), camera.rotation.reshape(16), _sky_position(camera, atmo),
        atmo.planet_radius_mm.reshape(1), atmo.atmosphere_radius_mm.reshape(1), sun, _light_proj(atmo),
        _normalize(-sun), vec_norm(-sun).reshape(1), atmo.sun_angular_radius.reshape(1),
        atmo.sun_intensity_spectrum.reshape(3), frame.reshape(16), aerial.t_sun0.reshape(3),
    ]
    table = torch.cat(parts)
    if table.dtype != F32 or table.shape != (SKY_TABLE,):
        raise ValueError(f"the sky table is {table.shape[0]} {table.dtype} values, the kernel reads {SKY_TABLE} f32")
    return table


def _skyview_format(lut):
    """The sky-view LUT as the kernel reads it: (format, data, q8 scales,
    height, width)."""
    if isinstance(lut, LUTQ8):
        h, w = lut.scale.shape
        if lut.q.dtype != torch.uint8 or tuple(lut.q.shape) != (h, w, 12) or lut.scale.dtype != F32:
            raise ValueError(f"a q8 sky-view LUT must be ({h}, {w}, 12) uint8 codes and f32 scales")
        return SKY_Q8, lut.q.contiguous(), lut.scale.contiguous(), h, w
    formats = {F32: SKY_F32, torch.float16: SKY_F16}
    if lut.dtype not in formats or lut.dim() != 3 or lut.shape[-1] != 3:
        raise ValueError(f"the sky-view LUT must be (H, W, 3) f32 or f16, got {tuple(lut.shape)} {lut.dtype}")
    return formats[lut.dtype], lut.contiguous(), None, lut.shape[0], lut.shape[1]


def _launch_kernel(
    scene_color, scene_depth, gbuffer, camera, atmo, transmittance_lut, skyview_lut, sun_light, sun_shadow_map,
    aerial, tseg_rows, sun_shadow, draw_extent, aerial_t_max, metallic_reflection, f16, q8, row_origin,
):
    """Launch ``csrc/sky.cu`` over the block's (rows, W) pixels, the sun's
    taps rounded to f16 (``f16``) or decoded from q8 segments (``q8``)."""
    rows, width = scene_depth.shape
    dev = scene_depth.device
    planes = [pixel_plane(p, (rows, width, 4), f"G-buffer plane {name}") for name, p in zip(GBuffer._fields, gbuffer)]
    depth = pixel_plane(scene_depth, (rows, width), "scene_depth")
    color = pixel_plane(scene_color, (rows, width, 3), "scene_color")
    if sun_shadow is not None:
        sun_shadow = pixel_plane(sun_shadow, (rows, width), "sun_shadow")
    if transmittance_lut.dtype != F32 or transmittance_lut.dim() != 3 or transmittance_lut.shape[-1] != 3:
        raise ValueError(f"the transmittance LUT must be (H, W, 3) f32, got {tuple(transmittance_lut.shape)}")
    volume = aerial.volume
    if volume.dtype != F32 or volume.dim() != 4 or volume.shape[-1] != 9:
        raise ValueError(f"the aerial LUT must be (n_y, n_x, n_s, 9) f32, got {tuple(volume.shape)} {volume.dtype}")
    if tseg_rows is not None and (tseg_rows.dtype != F32 or tseg_rows.dim() != 2 or tseg_rows.shape[1] != 6):
        raise ValueError(f"the t_seg rows must be (h, 6) f32, got {tuple(tseg_rows.shape)}")
    size = sun_shadow_map.shape[-1]
    if sun_shadow_map.dtype != F32 or tuple(sun_shadow_map.shape) != (size, size):
        raise ValueError(f"the sun's shadow map must be (dim, dim) f32, got {tuple(sun_shadow_map.shape)}")
    fmt, sky, sky_scale, sky_h, sky_w = _skyview_format(skyview_lut)
    t_lut, volume = transmittance_lut.contiguous(), volume.contiguous()
    tseg = None if tseg_rows is None else tseg_rows.contiguous()
    sun_map = sun_shadow_map.contiguous()
    table = sky_table(camera, atmo, sun_light, aerial)
    tensors = [*planes, depth, color, t_lut, sky, volume, sun_map, table] + [
        t for t in (sun_shadow, sky_scale, tseg) if t is not None
    ]
    if any(t.device != dev for t in tensors):
        raise ValueError("the sky pass's inputs must be on one device")
    codes, lo16, step16, n_w = q8_tables(sun_map[None]) if q8 else (None, None, None, 0)
    out = torch.empty((rows, width, 3), dtype=F32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    draw_w, draw_h = draw_extent
    build.launch(
        "szg_sky", dev,
        *[p.data_ptr() for p in planes], depth.data_ptr(), color.data_ptr(), ptr(sun_shadow), table.data_ptr(),
        t_lut.data_ptr(), t_lut.shape[0], t_lut.shape[1], sky.data_ptr(), ptr(sky_scale), sky_h, sky_w, fmt,
        ptr(tseg), 0 if tseg is None else tseg.shape[0], volume.data_ptr(), *volume.shape[:3], float(aerial_t_max),
        sun_map.data_ptr(), size, int(f16), ptr(codes), ptr(lo16), ptr(step16), n_w,
        int(metallic_reflection), rows, width, row_origin, draw_w, draw_h, out.data_ptr(), counts={"sky": 1},
    )
    return out


def sky_camera_pass(
    scene_color,  # (H, W, 3) lit geometry
    scene_depth,  # (H, W)
    gbuffer: GBuffer,
    camera: CameraPacked,
    atmo: AtmospherePacked,
    transmittance_lut,
    skyview_lut,
    sun_light: DirectionalLight,  # row 0 of the stacked lights
    sun_shadow_map,  # (dim, dim)
    draw_extent: tuple[int, int],  # (w, h) viewport for the rays
    aerial: AerialLUT | None = None,  # None: the quirk-exact per-pixel integrals
    aerial_t_max: float = 0.0,
    tseg_rows=None,
    metallic_reflection: bool = True,
    pcf_f16: bool = False,
    row_origin: int = 0,  # global row of this block's first row
    fast: bool = False,  # exp-step integrals (quirk-exact formulation only)
    fast_reflection: bool = False,  # exp-step integral for the bounce's environment only
    pcf_q8: bool = False,
    sun_shadow=None,  # (H, W) sun PCF shared with the lighting pass, or None
    exact: ExactAerial | None = None,  # the quirk-exact integrals, computed ahead
):
    """``camera.comp`` main (``:303-395``) -> (H, W, 3) tonemapped color
    (``sky.py:598-822``). The ``pcf_*`` flags go to the sun's
    :func:`sample_shadow_map`; a given ``sun_shadow`` (the same PCF,
    evaluated once for both passes: ``RenderConfig.share_sun_pcf``)
    replaces it. With ``aerial``, CUDA tensors launch ``csrc/sky.cu``
    once (with the plain version's gradient where autograd needs the
    inputs, :func:`kernels.plain_gradient.dispatch`) and CPU tensors take
    :func:`sky_camera_pass_lut_plain`. Without ``aerial``, ``exact``
    gives the per-pixel integrals and the pixels they were taken over
    (:func:`aerial_integrals_exact` of the same block and settings);
    without it the pass computes them itself."""
    if aerial is not None:
        args = (
            scene_color, scene_depth, gbuffer, camera, atmo, transmittance_lut, skyview_lut, sun_light,
            sun_shadow_map, aerial, tseg_rows, sun_shadow,
        )
        small = sun_shadow_map.shape[-1] <= PCF_WINDOW_MAX_DIM
        taps = (pcf_f16 and small, pcf_q8 and small and sun_shadow is None)  # a given sun_shadow takes none

        def kernel():
            return _launch_kernel(*args, draw_extent, aerial_t_max, metallic_reflection, *taps, row_origin)

        def plain(*a):
            return sky_camera_pass_lut_plain(
                *a, draw_extent, aerial_t_max, metallic_reflection, pcf_f16, pcf_q8, row_origin,
            )

        return dispatch(scene_depth.device, kernel, plain, args)

    if exact is None:
        exact = aerial_integrals_exact(
            scene_depth, gbuffer, camera, atmo, transmittance_lut, draw_extent,
            metallic_reflection, row_origin, fast, fast_reflection,
        )
    if sun_shadow is None:
        sun_shadow = directional_pcf(sun_light, exact.pixels.material, sun_shadow_map, f16=pcf_f16, q8=pcf_q8)
    env_transfer, geo_transfer = _transfers_exact(atmo, transmittance_lut, skyview_lut, exact, sun_shadow)
    return _composite(exact.pixels.is_env, env_transfer, geo_transfer, scene_color, atmo)
