"""Sky/ground/aerial-perspective camera pass (port of ``camera.comp``).

Port of ``syzygy_tpu/kernels/sky.py`` for the aerial-LUT formulation (the
reference's default, ``RenderConfig.aerial_lut=True``): geometry pixels
trilinearly sample a 32x32x16 froxel volume built with the exact
in-scattering integral, environment pixels share one skyview and one
transmittance sample across the ground/sky branches, and the ground
branch's camera->surface transmittance comes from the per-row t_seg table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from syzygy_tpu_torch.kernels.atmosphere import (
    METERS_PER_MM,
    PI,
    luminance_scattering_integral,
    ray_sphere_intersect,
    safe_sqrt,
    sample_lut_bilinear,
    sample_transmittance_ray,
    sample_transmittance_rmu,
    sample_transmittance_segment,
)
from syzygy_tpu_torch.kernels.lighting import (
    PBRTexel,
    _dot1,
    _normalize,
    compute_fresnel,
    compute_shadow_frame,
    convert_pbr,
    diffuse_brdf,
    sample_shadow_map,
    specular_brdf,
)
from syzygy_tpu_torch.kernels.resolve import GBuffer
from syzygy_tpu_torch.math.geometry import matmul4, matvec, sqrt_rn, vec_norm
from syzygy_tpu_torch.scene.atmosphere import AtmospherePacked
from syzygy_tpu_torch.scene.camera import CameraPacked
from syzygy_tpu_torch.scene.lights import DirectionalLight

F32 = torch.float32


def _norm3(v):
    return sqrt_rn(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-20))


def _flip(device):
    return torch.tensor([1.0, -1.0, 1.0], dtype=F32, device=device)


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

    sun = atmo.incident_direction_sun
    light_proj = -torch.stack([sun[0], sun[2]])
    light_proj = light_proj / torch.clamp(vec_norm(light_proj), min=1e-12)
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


def _hit_planet(atmo, origin, direction):
    hit, t0, _ = ray_sphere_intersect(origin, direction, atmo.planet_radius_mm)
    return hit & (t0 > 0.0), t0


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
    hit, dist = _hit_planet(atmo, position, direction)
    surface = position + dist[..., None] * direction

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
    surface_normal = surface / _norm3(surface)
    halfway = _normalize(light_dir + (-direction))
    spec_power = 160.0
    microfacet = torch.pow(torch.clamp(_dot1(halfway, surface_normal), 0.0, 1.0), spec_power)
    specular = (spec_power + 2.0) / 8.0 * microfacet
    diffuse = 0.4 / PI
    fresnel = 0.04 + (1.0 - 0.04) * torch.pow(
        1.0 - torch.clamp(_dot1(halfway, light_dir), 0.0, 1.0), 5.0
    )
    albedo = diffuse * (1.0 - fresnel) + specular * fresnel
    nl = torch.clamp(torch.sum(surface_normal * light_dir, dim=-1, keepdim=True), 0.0, 1.0)
    surface_lum = t_shared * albedo * nl
    if tseg_rows is not None:
        t_surface = _sample_tseg_rows(tseg_rows, v_sel)
    else:
        t_surface = sample_transmittance_segment(transmittance_lut, atmo, position, surface)
    ground = surface_lum * t_surface + sky

    # sun disk (sampleSunDisk, camera.comp:123-140)
    to_sun = -atmo.incident_direction_sun
    cos_dir_sun = torch.sum(direction * to_sun, dim=-1) / (
        _norm3(direction)[..., 0] * vec_norm(to_sun)
    )
    sin_sun_radius = atmo.sun_angular_radius
    sin_dir_sun = safe_sqrt(1.0 - cos_dir_sun * cos_dir_sun)
    edge0 = 0.2 * sin_sun_radius
    t = torch.clamp((sin_dir_sun - edge0) / torch.clamp(sin_sun_radius - edge0, min=1e-12), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    disk = t_shared * (1.0 - smooth)[..., None]
    disk = torch.where((cos_dir_sun < 0.0)[..., None], 0.0, disk)
    hit3 = hit[..., None]
    return torch.where(hit3, ground, sky), torch.where(hit3, 0.0, disk)


def geometry_luminance_transfer(
    atmo, transmittance_lut, direction, material: PBRTexel, shadow_factor,
    aerial, t_surface, t_sun,
):
    """``computeGeometryLuminanceTransfer`` (``camera.comp:237-278``) with
    the path/sun transmittances and in-scatter taken from the froxel
    volume (``sky.py:365-409``)."""
    surface = material.position
    light_dir = _normalize(-atmo.incident_direction_sun)
    view_dir = -direction / _norm3(direction)
    shadowed_by_planet, _ = _hit_planet(atmo, surface, light_dir.expand(surface.shape))
    fresnel = compute_fresnel(material, light_dir, view_dir)
    # fractionOfSunVisible early-returns sinHorizonZenith (camera.comp:147)
    frac_visible = atmo.planet_radius_mm / _norm3(surface)[..., 0]
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
    aerial: AerialLUT,
    aerial_t_max: float,
    tseg_rows=None,
    metallic_reflection: bool = True,
    pcf_f16: bool = False,
    row_origin: int = 0,
):
    """``camera.comp`` main (``:303-395``) -> (H, W, 3) tonemapped color,
    aerial-LUT formulation (``sky.py:598-822``)."""
    h, w = scene_depth.shape
    dev = scene_depth.device
    draw_w, draw_h = draw_extent
    flip = _flip(dev)
    up_r = torch.stack([torch.zeros_like(atmo.planet_radius_mm), atmo.planet_radius_mm,
                        torch.zeros_like(atmo.planet_radius_mm)])

    # engine (+y down, meters) -> sky space (+y up, Mm) (camera.comp:318-322)
    position = camera.position[:3] / METERS_PER_MM * flip + up_r

    # per-pixel view ray (camera.comp:324-328). The reference's compiled
    # ``i / extent - 0.5`` is ``fma(i, 1 / extent, -0.5)`` (division by a
    # constant becomes a reciprocal multiply, then contracts); exact for
    # power-of-two extents, one rounding fewer otherwise.
    def centred(i, extent):
        inv = torch.tensor(1.0 / extent, dtype=F32, device=dev)
        return (i.double() * inv.double() - 0.5).float() * 2.0

    xs = centred(torch.arange(w, dtype=F32, device=dev)[None, :], draw_w)
    rows = torch.arange(h, dtype=F32, device=dev) + float(row_origin)
    ys = centred(rows[:, None], draw_h)
    clip_uv = torch.stack([xs.expand(h, w), ys.expand(h, w)], dim=-1)
    ones = torch.ones((h, w, 1), dtype=F32, device=dev)
    view_h = matvec(camera.inverse_projection, torch.cat([clip_uv, ones, ones], dim=-1))
    direction = matvec(camera.rotation, view_h)[..., :3]
    direction = direction / _norm3(direction)
    direction = direction * flip

    material = convert_pbr(gbuffer)
    sky_material = material._replace(
        normal=material.normal * flip,
        position=material.position * flip / METERS_PER_MM + up_r,
    )
    pos_grid = position.expand(direction.shape)
    is_env = (scene_depth == 0.0) | (material.position[..., 1] > 0.0)
    dist_surface = vec_norm(sky_material.position - pos_grid)

    coord, dx, dy = compute_shadow_frame(
        matmul4(sun_light.projection, sun_light.view), material.position, material.normal
    )
    sun_shadow = sample_shadow_map(sun_shadow_map, coord, dx, dy, f16=pcf_f16)

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

    env3 = is_env[..., None]
    transfer = torch.where(env3, env_transfer, geo_transfer)
    surface_luminance = torch.where(env3, 0.0, scene_color)
    luminance = transfer * atmo.sun_intensity_spectrum
    return torch.pow(torch.clamp(luminance * 10.0 + surface_luminance, min=0.0), 1.2)
