"""Hillaire atmospheric scattering: LUT construction and sampling.

Port of ``syzygy_tpu/kernels/atmosphere.py`` (``atmosphere/common.glinl``,
``transmittance_LUT.comp``, ``skyview_LUT.comp``), keeping the reference's
quirks: ``sampleExtinction`` uses the Rayleigh absorption for the Mie term
(``common.glinl:202``) and ``stepRadiusMu`` takes ``safeSqrt`` of a
difference (``common.glinl:325``). Units: megameters, +y up.

LUTs are stored plain (``(H, W, C)`` f32, or the q8 sky-view form); the
TPU's quad packing (one gather per bilinear footprint) is a gather layout
that does not change values and is not carried over.

The 32-step LUT-ratio integral takes one of two forms by its LUT's
device: on a CUDA tensor :func:`luminance_scattering_integral` and
:func:`_scattering_integral_components` launch ``csrc/scattering.cu``,
one thread per ray, bitwise :func:`luminance_scattering_integral_plain`
and :func:`_scattering_integral_components_plain`; on the CPU they run
those. On the card, inputs that need a gradient get the plain version's.
:data:`LAUNCHES` counts the kernel's launches and the rays they
integrated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from syzygy_tpu_torch.kernels import build
from syzygy_tpu_torch.kernels.plain_gradient import PlainGradient, grad_leaves
from syzygy_tpu_torch.kernels.raster import LaunchCounts
from syzygy_tpu_torch.math.geometry import dot3_fma, fma32, sqrt_rn, vec_norm
from syzygy_tpu_torch.scene.atmosphere import AtmospherePacked

F32 = torch.float32
TRANSMITTANCE_SAMPLES = 500  # transmittance_LUT.comp:53
SKYVIEW_SAMPLES = 32  # common.glinl:363
METERS_PER_MM = 1_000_000.0
PI = 3.141592653589793
_TRANSMITTANCE_STEP_BLOCK = 50  # optical-depth steps evaluated per tensor op


def safe_sqrt(x):
    return sqrt_rn(torch.clamp(x, min=0.0))


def _norm(v):
    return sqrt_rn(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-20))


def tex_coord_from_unit_range(value, dim: int):
    """``textureCoordFromUnitRange`` (``common.glinl:29-32``)."""
    return 0.5 / dim + value * (1.0 - 1.0 / dim)


def unit_range_from_tex_coord(coord, dim: int):
    return (coord - 0.5 / dim) / (1.0 - 1.0 / dim)


def transmittance_rmu_to_uv(atmo: AtmospherePacked, radius, mu, width: int, height: int):
    """``transmittanceLUT_RMu_to_UV`` (``common.glinl:40-66``); the half-texel
    insets follow the LUT dims."""
    atm_r2 = atmo.atmosphere_radius_mm * atmo.atmosphere_radius_mm
    pl_r2 = atmo.planet_radius_mm * atmo.planet_radius_mm
    h = safe_sqrt(atm_r2 - pl_r2)
    rho = safe_sqrt(radius * radius - pl_r2)
    d = torch.clamp(
        -radius * mu + safe_sqrt(radius * radius * (mu * mu - 1.0) + atm_r2), min=0.0
    )
    d_min = atmo.atmosphere_radius_mm - radius
    d_max = rho + h
    x_mu = (d - d_min) / torch.clamp(d_max - d_min, min=1e-12)
    x_radius = rho / torch.clamp(h, min=1e-12)
    return tex_coord_from_unit_range(x_mu, width), tex_coord_from_unit_range(x_radius, height)


def transmittance_uv_to_rmu(atmo: AtmospherePacked, u, v, width: int, height: int):
    """``transmittanceLUT_UV_to_RMu`` (``common.glinl:69-102``)."""
    x_mu = unit_range_from_tex_coord(u, width)
    x_radius = unit_range_from_tex_coord(v, height)
    atm_r2 = atmo.atmosphere_radius_mm * atmo.atmosphere_radius_mm
    pl_r2 = atmo.planet_radius_mm * atmo.planet_radius_mm
    h = safe_sqrt(atm_r2 - pl_r2)
    rho = h * x_radius
    radius = sqrt_rn(rho * rho + pl_r2)
    d_min = atmo.atmosphere_radius_mm - radius
    d_max = rho + h
    d = (d_max - d_min) * x_mu + d_min
    mu = (h * h - rho * rho - d * d) / (2.0 * radius * torch.clamp(d, min=1e-12))
    mu = torch.clamp(mu, -1.0, 1.0)
    return radius, torch.where(d <= 0.0, 1.0, mu)


class LUTQ8(NamedTuple):
    """u8 block-scaled LUT (``pack_lut_q8``, ``atmosphere.py:181-201``):
    each texel's clamped 2x2 bilinear footprint quantized to u8 fractions
    of the footprint's own max. Stored decoded-ready: ``q`` (H, W, 12) u8
    and ``scale`` (H, W) f32."""

    q: torch.Tensor
    scale: torch.Tensor


def _footprint(lut: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C): [t(y,x), t(y,x1), t(y1,x), t(y1,x1)],
    x1/y1 edge-clamped."""
    h, w = lut.shape[0], lut.shape[1]
    xr = torch.clamp(torch.arange(w, device=lut.device) + 1, max=w - 1)
    yd = torch.clamp(torch.arange(h, device=lut.device) + 1, max=h - 1)
    return torch.cat([lut, lut[:, xr], lut[yd], lut[yd][:, xr]], dim=-1)


def pack_lut_q8(lut: torch.Tensor) -> LUTQ8:
    """(H, W, 3) -> :class:`LUTQ8`. ``torch.round`` rounds half to even,
    as ``jnp.round`` does, so the u8 codes agree with the reference's."""
    quad = _footprint(lut)
    scale = torch.amax(quad, dim=-1, keepdim=True)
    q = torch.clamp(torch.round(quad / torch.clamp(scale, min=1e-30) * 255.0), 0.0, 255.0)
    return LUTQ8(q.to(torch.uint8), scale[..., 0])


def _texel(table, iy, ix):
    """``table[iy, ix]`` for index tensors of any shape: 0-dim indices are
    taken as 1-element tensors, so no index is read back to the host."""
    iy, ix = torch.broadcast_tensors(iy, ix)
    return table[iy.reshape(-1), ix.reshape(-1)].reshape(*iy.shape, *table.shape[2:])


def sample_lut_bilinear(lut, u, v):
    """Bilinear clamp-to-edge sample (GLSL ``texture()``) of an (H, W, C)
    LUT (any float dtype; filtered in f32) or a :class:`LUTQ8`."""
    if isinstance(lut, LUTQ8):
        h, w = lut.scale.shape
    else:
        h, w = lut.shape[0], lut.shape[1]
    x = torch.clamp(u * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    if isinstance(lut, LUTQ8):
        scale = (_texel(lut.scale, y0, x0) * (1.0 / 255.0))[..., None]
        q = _texel(lut.q, y0, x0).to(F32) * scale  # (..., 12)
        top = q[..., 0:3] * (1 - fx) + q[..., 3:6] * fx
        bot = q[..., 6:9] * (1 - fx) + q[..., 9:12] * fx
        return top * (1 - fy) + bot * fy
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    top = _texel(lut, y0, x0).to(F32) * (1 - fx) + _texel(lut, y0, x1).to(F32) * fx
    bot = _texel(lut, y1, x0).to(F32) * (1 - fx) + _texel(lut, y1, x1).to(F32) * fx
    return top * (1 - fy) + bot * fy


def sample_transmittance_rmu(lut, atmo, radius, mu):
    h, w = lut.shape[0], lut.shape[1]
    u, v = transmittance_rmu_to_uv(atmo, radius, mu, w, h)
    return sample_lut_bilinear(lut, u, v)


def sample_transmittance_ray(lut, atmo, position, direction):
    """``sampleTransmittanceLUT_Ray`` (``common.glinl:104-112``)."""
    radius = _norm(position)[..., 0]
    mu = torch.sum(position * direction, dim=-1) / (radius * _norm(direction)[..., 0])
    return sample_transmittance_rmu(lut, atmo, radius, mu)


def sample_transmittance_segment(lut, atmo, p_from, p_to):
    """``sampleTransmittanceLUT_Segment`` (``common.glinl:114-136``) with the
    direction-flip trick for precision near the horizon."""
    direction = (p_to - p_from) / _norm(p_to - p_from)
    flip = torch.sum(p_from * direction, dim=-1, keepdim=True) < 0.0
    a = torch.where(flip, p_to, p_from)
    b = torch.where(flip, p_from, p_to)
    d = torch.where(flip, -direction, direction)
    transmittance = sample_transmittance_ray(lut, atmo, a, d) / torch.clamp(
        sample_transmittance_ray(lut, atmo, b, d), min=1e-20
    )
    return torch.clamp(transmittance, 0.0, 1.0)


def sample_transmittance_sun(lut, atmo, radius, cos_sun_zenith):
    """``sampleTransmittanceLUT_Sun`` (``common.glinl:145-172``)."""
    sin_sun_radius = torch.sin(atmo.sun_angular_radius)
    cos_sun_radius = torch.cos(atmo.sun_angular_radius)
    sin_horizon = atmo.planet_radius_mm / radius
    cos_horizon = -safe_sqrt(1.0 - sin_horizon * sin_horizon)
    through = sample_transmittance_rmu(lut, atmo, radius, cos_sun_zenith)
    edge0 = -sin_horizon * sin_sun_radius
    edge1 = sin_horizon * sin_sun_radius
    x = cos_sun_zenith - cos_horizon * cos_sun_radius
    t = torch.clamp((x - edge0) / torch.clamp(edge1 - edge0, min=1e-12), 0.0, 1.0)
    return through * (t * t * (3.0 - 2.0 * t))[..., None]


class ExtinctionSample(NamedTuple):
    scattering_rayleigh: torch.Tensor
    scattering_mie: torch.Tensor
    extinction: torch.Tensor


def sample_extinction(atmo: AtmospherePacked, altitude_mm) -> ExtinctionSample:
    """``sampleExtinction`` (``common.glinl:194-216``), keeping the
    absorptionRayleigh-for-Mie slip; altitude clamps at -1 km (the
    reference's robustness deviation)."""
    alt = torch.clamp(altitude_mm, min=-0.001)[..., None]
    density_rayleigh = torch.exp(-alt / atmo.density_scale_rayleigh_mm)
    scattering_rayleigh = atmo.scattering_rayleigh_per_mm * density_rayleigh
    absorption_rayleigh = atmo.absorption_rayleigh_per_mm * density_rayleigh
    density_mie = torch.exp(-alt / atmo.density_scale_mie_mm)
    scattering_mie = atmo.scattering_mie_per_mm * density_mie
    absorption_mie = atmo.absorption_rayleigh_per_mm * density_mie  # reference quirk
    altitude_km = altitude_mm * 1000.0
    density_ozone = torch.clamp(1.0 - torch.abs(altitude_km - 25.0) / 15.0, min=0.0)[..., None]
    scattering_ozone = atmo.scattering_ozone_per_mm * density_ozone
    absorption_ozone = atmo.absorption_ozone_per_mm * density_ozone
    extinction = (
        scattering_rayleigh
        + absorption_rayleigh
        + scattering_mie
        + absorption_mie
        + scattering_ozone
        + absorption_ozone
    )
    return ExtinctionSample(scattering_rayleigh, scattering_mie, extinction)


def ray_sphere_intersect(origin, direction, radius):
    """``raySphereIntersection`` (``common.glinl:220-260``) -> (hit, t0, t1),
    t0 <= t1, both 0 on a miss."""
    b = -torch.sum(origin * direction, dim=-1)
    chord = origin + b[..., None] * direction
    discriminant = radius * radius - torch.sum(chord * chord, dim=-1)
    c = torch.sum(origin * origin, dim=-1) - radius * radius
    return _ray_sphere_roots(b, discriminant, c)


def ray_sphere_intersect_fma(origin, direction, radius):
    """:func:`ray_sphere_intersect` with the arithmetic the reference's
    compiled sky pass gives it: its dot products are fused multiply-add
    chains and ``origin + b * direction`` is contracted (its LUT builders'
    fusions keep the plain form). For a camera metres above the ground,
    ``c = |origin|^2 - r^2`` keeps a few significant bits, so any other
    rounding moves a grazing ray's hit far."""
    b = -dot3_fma(origin, direction)
    chord = fma32(b[..., None], direction, origin)
    rr = radius * radius
    return _ray_sphere_roots(b, rr - dot3_fma(chord, chord), dot3_fma(origin, origin) - rr)


def _ray_sphere_roots(b, discriminant, c):
    hit = discriminant >= 0.0
    sq = safe_sqrt(discriminant)
    q = torch.where(b < 0.0, b - sq, b + sq)
    t0 = c / torch.where(torch.abs(q) < 1e-12, 1e-12, q)
    lo = torch.minimum(t0, q)
    hi = torch.maximum(t0, q)
    return hit, torch.where(hit, lo, 0.0), torch.where(hit, hi, 0.0)


def phase_rayleigh(cosine):
    return 3.0 / (16.0 * PI) * (1.0 + cosine * cosine)


def phase_mie(cosine, g=0.8):
    num = (1.0 - g * g) * (1.0 + cosine * cosine)
    den = (2.0 + g * g) * torch.pow(torch.clamp(1.0 + g * g - 2.0 * g * cosine, min=1e-12), 1.5)
    return 3.0 / (8.0 * PI) * num / den


def raycast_atmosphere(atmo, origin, direction):
    """``raycastAtmosphere`` (``common.glinl:284-307``) -> distance through."""
    hit_a, a0, a1 = ray_sphere_intersect(origin, direction, atmo.atmosphere_radius_mm)
    hit_atmo = hit_a & (a1 > 0.0)
    a0 = torch.clamp(a0, min=0.0)
    hit_p, p0, _ = ray_sphere_intersect(origin, direction, atmo.planet_radius_mm)
    hit_planet = hit_p & (p0 > 0.0)
    a1 = torch.where(hit_planet, torch.minimum(p0, a1), a1)
    return torch.where(hit_atmo, a1 - a0, 0.0)


class RaymarchStep(NamedTuple):
    radius: torch.Tensor
    mu: torch.Tensor
    mu_sun: torch.Tensor


def step_radius_mu(start: RaymarchStep, step_distance) -> RaymarchStep:
    """``stepRadiusMu`` (``common.glinl:316-334``)."""
    mu_sun_step = safe_sqrt(
        start.mu_sun * start.mu
        - safe_sqrt((1.0 - start.mu_sun * start.mu_sun) * (1.0 - start.mu * start.mu))
    )
    radius = safe_sqrt(
        step_distance * step_distance
        + 2.0 * start.radius * start.mu * step_distance
        + start.radius * start.radius
    )
    safe_radius = torch.clamp(radius, min=1e-12)
    return RaymarchStep(
        radius=radius,
        mu=(start.radius * start.mu + step_distance) / safe_radius,
        mu_sun=(start.radius * start.mu_sun + step_distance * mu_sun_step) / safe_radius,
    )


def sample_transmittance_raymarch_step(atmo, lut, start: RaymarchStep, step_distance):
    """``sampleTransmittanceLUT_RayMarchStep`` (``common.glinl:336-361``,
    ``atmosphere.py:402-419``): the transmittance from ``start`` over
    ``step_distance`` along its ray, read from the LUT toward the sky for
    rays going up and toward the ground (``-mu``) for rays going down;
    1 for steps under 1e-7. The integrals inline an equivalent form with
    the origin's samples hoisted (:func:`_march_step`), so nothing on the
    frame calls this one, as in the reference."""
    end = step_radius_mu(start, step_distance)
    up = start.mu > 0.0
    a_r = torch.where(up, start.radius, end.radius)
    a_mu = torch.where(up, start.mu, -end.mu)
    b_r = torch.where(up, end.radius, start.radius)
    b_mu = torch.where(up, end.mu, -start.mu)
    transmittance = sample_transmittance_rmu(lut, atmo, a_r, a_mu) / torch.clamp(
        sample_transmittance_rmu(lut, atmo, b_r, b_mu), min=1e-20
    )
    transmittance = torch.clamp(transmittance, 0.0, 1.0)
    tiny = (step_distance < 1e-7)[..., None]
    return torch.where(tiny, 1.0, transmittance)


def _ray_step_setup(atmo, origin, direction, sample_distance):
    """The origin step, the scattering direction and the step length of a
    32-step march."""
    scattering_dir = -direction / _norm(direction)
    radius = _norm(origin)[..., 0]
    mu = torch.sum(origin * direction, dim=-1) / (radius * _norm(direction)[..., 0])
    sun = atmo.incident_direction_sun
    mu_sun = torch.sum(origin * (-sun), dim=-1) / (radius * vec_norm(sun))
    return scattering_dir, RaymarchStep(radius, mu, mu_sun), sample_distance / SKYVIEW_SAMPLES


def _march_setup(atmo, lut, origin, direction, sample_distance):
    """Per-ray invariants of the 32-step integral: the origin step, the
    step length, the hoisted origin-side transmittance samples."""
    scattering_dir, origin_step, d_sample = _ray_step_setup(atmo, origin, direction, sample_distance)
    up = (origin_step.mu > 0.0)[..., None]
    t_start_up = sample_transmittance_rmu(lut, atmo, origin_step.radius, origin_step.mu)
    t_start_dn = sample_transmittance_rmu(lut, atmo, origin_step.radius, -origin_step.mu)
    return scattering_dir, origin_step, d_sample, up, t_start_up, t_start_dn


def _march_step(atmo, lut, origin, i, scattering_dir, origin_step, d_sample, up, t_start_up, t_start_dn):
    """One step of ``computeLuminanceScatteringIntegral``: (extinction
    sample, t_sun, integral, t_begin)."""
    t = i * d_sample
    begin = origin - (i * d_sample)[..., None] * scattering_dir
    end = origin - ((i + 1.0) * d_sample)[..., None] * scattering_dir
    sample_step = step_radius_mu(origin_step, t)
    altitude = _norm(begin)[..., 0] - atmo.planet_radius_mm
    t_sun = sample_transmittance_sun(lut, atmo, sample_step.radius, sample_step.mu_sun)
    ext = sample_extinction(atmo, altitude)
    s_end = sample_transmittance_rmu(
        lut, atmo, sample_step.radius, torch.where(up[..., 0], sample_step.mu, -sample_step.mu)
    )
    t_begin = torch.clamp(
        torch.where(
            up,
            t_start_up / torch.clamp(s_end, min=1e-20),
            s_end / torch.clamp(t_start_dn, min=1e-20),
        ),
        0.0,
        1.0,
    )
    t_begin = torch.where((t < 1e-7)[..., None], 1.0, t_begin)
    t_path = sample_transmittance_segment(lut, atmo, begin, end)
    integral = (1.0 - t_path) / torch.clamp(ext.extinction, min=1e-12)
    return ext, t_sun, integral, t_begin


def luminance_scattering_integral_plain(atmo, lut, origin, direction, sample_distance):
    """``computeLuminanceScatteringIntegral`` (``common.glinl:363-424``)
    with the step-invariant origin-side transmittance hoisted
    (``atmosphere.py:423-492``), in tensor operations."""
    setup = _march_setup(atmo, lut, origin, direction, sample_distance)
    scattering_dir = setup[0]
    incident_cos = torch.sum(atmo.incident_direction_sun * scattering_dir, dim=-1)
    phase_r = phase_rayleigh(incident_cos)[..., None]
    phase_m = phase_mie(incident_cos, 0.8)[..., None]
    luminance = torch.zeros((*sample_distance.shape, 3), dtype=F32, device=origin.device)
    for i in range(SKYVIEW_SAMPLES):
        ext, t_sun, integral, t_begin = _march_step(atmo, lut, origin, float(i), *setup)
        phase_scat = ext.scattering_rayleigh * phase_r + ext.scattering_mie * phase_m
        luminance = luminance + phase_scat * t_sun * integral * t_begin
    return luminance


def luminance_scattering_integral_fast(atmo, lut, origin, direction, sample_distance):
    """The exp-step integral (``atmosphere.py:495-570``): the same 32
    sample points, phase and extinction as
    :func:`luminance_scattering_integral`, with the path transmittance
    carried as a running product of ``exp(-extinction * dt)`` and the
    per-step ``(1 - T_step) / extinction`` from the same exponential; only
    the sun transmittance still samples the LUT. Not parity-exact with the
    LUT-ratio integral (``RenderConfig.fast_sky``, off by default)."""
    scattering_dir, origin_step, d_sample = _ray_step_setup(atmo, origin, direction, sample_distance)
    incident_cos = torch.sum(atmo.incident_direction_sun * scattering_dir, dim=-1)
    phase_r = phase_rayleigh(incident_cos)[..., None]
    phase_m = phase_mie(incident_cos, 0.8)[..., None]
    luminance = torch.zeros((*sample_distance.shape, 3), dtype=F32, device=origin.device)
    t_acc = torch.ones_like(luminance)
    for i in range(SKYVIEW_SAMPLES):
        t = float(i) * d_sample
        begin = origin - t[..., None] * scattering_dir
        sample_step = step_radius_mu(origin_step, t)
        altitude = _norm(begin)[..., 0] - atmo.planet_radius_mm
        t_sun = sample_transmittance_sun(lut, atmo, sample_step.radius, sample_step.mu_sun)
        ext = sample_extinction(atmo, altitude)
        t_step = torch.exp(-d_sample[..., None] * ext.extinction)
        phase_scat = ext.scattering_rayleigh * phase_r + ext.scattering_mie * phase_m
        integral = (1.0 - t_step) / torch.clamp(ext.extinction, min=1e-12)
        luminance = luminance + phase_scat * t_sun * integral * t_acc
        t_acc = t_acc * t_step
    return luminance


def _scattering_integral_components_plain(atmo, lut, origin, direction, sample_distance):
    """The integral with the phase functions factored out
    (``atmosphere.py:615-683``): (A_rayleigh, A_mie), in tensor
    operations."""
    setup = _march_setup(atmo, lut, origin, direction, sample_distance)
    acc_r = torch.zeros((*sample_distance.shape, 3), dtype=F32, device=origin.device)
    acc_m = torch.zeros_like(acc_r)
    for i in range(SKYVIEW_SAMPLES):
        ext, t_sun, integral, t_begin = _march_step(atmo, lut, origin, float(i), *setup)
        common = t_sun * integral * t_begin
        acc_r = acc_r + ext.scattering_rayleigh * common
        acc_m = acc_m + ext.scattering_mie * common
    return acc_r, acc_m


class LaunchCount(LaunchCounts):
    """Scattering kernel launches and the rays they integrated, counted by
    :func:`luminance_scattering_integral` and
    :func:`_scattering_integral_components` where they launch the CUDA
    kernel and nowhere else (a frame replayed from a CUDA graph adds the
    launches it holds, ``renderer/frame.py``)."""

    KINDS = ("scattering", "scattering_rays")

    def reset(self) -> None:
        self.scattering = 0
        self.scattering_rays = 0


LAUNCHES = LaunchCount()
# the atmosphere's values that csrc/scattering.cu reads, in its order
_TABLE_FIELDS = (
    ("planet_radius_mm", 1), ("atmosphere_radius_mm", 1), ("density_scale_rayleigh_mm", 1),
    ("density_scale_mie_mm", 1), ("scattering_rayleigh_per_mm", 3), ("absorption_rayleigh_per_mm", 3),
    ("scattering_mie_per_mm", 3), ("scattering_ozone_per_mm", 3), ("absorption_ozone_per_mm", 3),
    ("incident_direction_sun", 3),
)


def scattering_table(atmo: AtmospherePacked) -> torch.Tensor:
    """What the kernel reads of the atmosphere, (25,) f32 on its device:
    the values of ``_TABLE_FIELDS`` in order, then ``sin`` and ``cos`` of
    ``sun_angular_radius`` and ``vec_norm(incident_direction_sun)``, each
    the plain version's own tensor operation (the kernel computes the
    rest from these)."""
    parts = []
    for name, size in _TABLE_FIELDS:
        value = getattr(atmo, name)
        if value.numel() != size:
            raise ValueError(f"atmosphere field {name} holds {value.numel()} values, the kernel reads {size}")
        parts.append(value.reshape(-1))
    sun = atmo.incident_direction_sun
    radius = atmo.sun_angular_radius.reshape(-1)
    parts += [torch.sin(radius), torch.cos(radius), vec_norm(sun).reshape(-1)]
    return torch.cat(parts).to(F32)


def _rays(origin, direction, sample_distance):
    """The integral's rays as the kernel reads them: (origin, its stride,
    directions (N, 3), distances (N,), the rays' batch shape). An origin
    that broadcasts to one value over the batch is passed once (stride
    0), any other as (N, 3) (stride 3); all f32."""
    for what, t in (("origin", origin), ("direction", direction), ("sample_distance", sample_distance)):
        if t.dtype != F32:
            raise ValueError(f"the integral's {what} must be float32, got {t.dtype}")
    if origin.dim() < 1 or origin.shape[-1] != 3 or direction.dim() < 1 or direction.shape[-1] != 3:
        raise ValueError(
            f"origin and direction must end in 3 components, got {tuple(origin.shape)} and {tuple(direction.shape)}"
        )
    try:
        batch = torch.broadcast_shapes(origin.shape[:-1], direction.shape[:-1], sample_distance.shape)
    except RuntimeError as e:
        raise ValueError(
            f"origin {tuple(origin.shape)}, direction {tuple(direction.shape)} and sample_distance "
            f"{tuple(sample_distance.shape)} do not broadcast: {e}"
        ) from None
    origin = origin.expand(*batch, 3)
    if all(s == 0 or n == 1 for s, n in zip(origin.stride()[:-1], batch)):
        origin, stride = origin[(0,) * len(batch)].contiguous(), 0
    else:
        origin, stride = origin.reshape(-1, 3).contiguous(), 3
    direction = direction.expand(*batch, 3).reshape(-1, 3).contiguous()
    distance = sample_distance.expand(batch).reshape(-1).contiguous()
    return origin, stride, direction, distance, batch


def _launch_kernel(components: bool, atmo, lut, origin, direction, sample_distance):
    """Launch ``csrc/scattering.cu`` over the rays: (A_r, A_m) with
    ``components``, else the luminance, each (*batch, 3)."""
    origin, stride, direction, distance, batch = _rays(origin, direction, sample_distance)
    if lut.dtype != F32 or lut.dim() != 3 or lut.shape[-1] != 3:
        raise ValueError(f"the transmittance LUT must be an (H, W, 3) float32 tensor, got {tuple(lut.shape)} {lut.dtype}")
    lut = lut.contiguous()
    table = scattering_table(atmo)
    dev = lut.device
    if any(t.device != dev for t in (origin, direction, distance, table)):
        raise ValueError("the rays, the atmosphere and the transmittance LUT must be on one device")
    n = distance.numel()
    out0 = torch.empty((n, 3), dtype=F32, device=dev)
    out1 = torch.empty((n, 3), dtype=F32, device=dev) if components else None
    if n:
        err = build.load("scattering").szg_scattering(
            origin.data_ptr(), stride, direction.data_ptr(), distance.data_ptr(), lut.data_ptr(), lut.shape[0],
            lut.shape[1], table.data_ptr(), out0.data_ptr(), None if out1 is None else out1.data_ptr(), n,
            int(components), dev.index, torch._C._cuda_getCurrentRawStream(dev.index),
        )
        if err != 0:
            raise RuntimeError(f"scattering kernel launch failed: CUDA error {err}")
        LAUNCHES.scattering += 1
        LAUNCHES.scattering_rays += n
    if components:
        return out0.reshape(*batch, 3), out1.reshape(*batch, 3)
    return out0.reshape(*batch, 3)


def _integral(components: bool, atmo, lut, origin, direction, sample_distance):
    """The plain version on the CPU; on the card the kernel, with the plain
    version's gradient where autograd needs the inputs."""
    plain = _scattering_integral_components_plain if components else luminance_scattering_integral_plain
    args = (atmo, lut, origin, direction, sample_distance)
    if lut.device.type != "cuda":
        return plain(*args)

    def kernel():
        with torch.no_grad():
            return _launch_kernel(components, *args)

    needs = grad_leaves(args) if torch.is_grad_enabled() else []
    return PlainGradient.apply(kernel, plain, args, *needs) if needs else kernel()


def luminance_scattering_integral(atmo, lut, origin, direction, sample_distance):
    """:func:`luminance_scattering_integral_plain`'s luminance, with its
    signature and its bits: on a CUDA LUT one launch of
    ``csrc/scattering.cu``, one thread per ray; CPU tensors take the
    plain version."""
    return _integral(False, atmo, lut, origin, direction, sample_distance)


def _scattering_integral_components(atmo, lut, origin, direction, sample_distance):
    """:func:`_scattering_integral_components_plain`'s (A_rayleigh,
    A_mie), dispatched as :func:`luminance_scattering_integral`."""
    return _integral(True, atmo, lut, origin, direction, sample_distance)


def compute_transmittance_lut(atmo: AtmospherePacked, width: int, height: int):
    """``transmittance_LUT.comp``: (height, width, 3) f32, 500-step optical
    depth (``atmosphere.py:572-612``). The steps are evaluated in blocks of
    50 per tensor op and multiplied in as block products, so the product's
    association differs from the reference's serial loop at the f32
    rounding level (inside the 2e-5 LUT class)."""
    dev = atmo.planet_radius_mm.device
    u = (torch.arange(width, dtype=F32, device=dev) + 0.5) / width
    v = (torch.arange(height, dtype=F32, device=dev) + 0.5) / height
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    radius, mu = transmittance_uv_to_rmu(atmo, uu, vv, width, height)
    zero = torch.zeros_like(radius)
    origin = torch.stack([zero, radius, zero], dim=-1)
    direction = torch.stack([safe_sqrt(1.0 - mu * mu), mu, zero], dim=-1)
    hit, _, distance = ray_sphere_intersect(origin, direction, atmo.atmosphere_radius_mm)
    dt = torch.abs(distance / TRANSMITTANCE_SAMPLES)[..., None]
    transmittance = torch.ones((height, width, 3), dtype=F32, device=dev)
    for start in range(0, TRANSMITTANCE_SAMPLES, _TRANSMITTANCE_STEP_BLOCK):
        i = torch.arange(start, start + _TRANSMITTANCE_STEP_BLOCK, dtype=F32, device=dev)
        t = distance[None] * (i[:, None, None] + 0.5) / TRANSMITTANCE_SAMPLES
        position = origin[None] + t[..., None] * direction[None]
        altitude = _norm(position)[..., 0] - atmo.planet_radius_mm
        ext = sample_extinction(atmo, altitude)
        transmittance = transmittance * torch.prod(torch.exp(-dt[None] * ext.extinction), dim=0)
    return torch.where(hit[..., None], transmittance, 1.0)


def compute_skyview_lut(
    atmo: AtmospherePacked, origin_mm, transmittance_lut, width: int, height: int,
    fast: bool = False, rowwise: bool = True,
):
    """``skyview_LUT.comp`` (``atmosphere.py:686-790``): the lat-long
    in-scattering map, (height, width, 3).

    ``rowwise`` (default, without ``fast``): with the origin on the
    planet-center axis every per-step term depends only on the LUT row
    (elevation), so the build is ``height`` row integrals plus a per-texel
    phase combination. Otherwise every texel integrates its own ray from
    ``origin_mm``, with the exp-step integral when ``fast``."""
    dev = origin_mm.device
    u = (torch.arange(width, dtype=F32, device=dev) + 0.5) / width
    v = (torch.arange(height, dtype=F32, device=dev) + 0.5) / height
    vv, uu = torch.meshgrid(v, u, indexing="ij")

    radius = vec_norm(origin_mm)
    sin_horizon = atmo.planet_radius_mm / radius
    horizon_zenith = PI - torch.asin(torch.clamp(sin_horizon, -1.0, 1.0))

    # azimuth (skyview_LUT.comp:58-69)
    cos_view_light = (uu - 0.5) * 2.0
    sun = atmo.incident_direction_sun
    light_proj = -torch.stack([sun[0], sun[2]])
    light_proj = light_proj / torch.clamp(vec_norm(light_proj), min=1e-12)
    azimuth_sun = torch.asin(torch.clamp(light_proj[0], -1.0, 1.0))
    azimuth_sun = torch.where(light_proj[1] < 0.0, PI - azimuth_sun, azimuth_sun)
    azimuth = torch.acos(torch.clamp(cos_view_light, -1.0, 1.0)) + azimuth_sun

    # elevation (skyview_LUT.comp:71-88)
    unnorm = 2.0 * vv - 1.0
    view_zenith = torch.where(
        vv < 0.5,
        (1.0 - unnorm * unnorm) * horizon_zenith,
        (PI - horizon_zenith) * (unnorm * unnorm) + horizon_zenith,
    )
    elevation = -(view_zenith - PI / 2.0)
    direction = torch.stack(
        [
            torch.sin(azimuth) * torch.cos(elevation),
            torch.sin(elevation),
            torch.cos(azimuth) * torch.cos(elevation),
        ],
        dim=-1,
    )
    if not rowwise or fast:
        origin = origin_mm.expand(direction.shape)
        distance = raycast_atmosphere(atmo, origin, direction)
        integral = luminance_scattering_integral_fast if fast else luminance_scattering_integral
        return integral(atmo, transmittance_lut, origin, direction, distance)
    elev_row = elevation[:, :1]
    dir_row = torch.stack(
        [torch.zeros_like(elev_row), torch.sin(elev_row), torch.cos(elev_row)], dim=-1
    )  # (h, 1, 3)
    origin_row = torch.stack([torch.zeros_like(radius), radius, torch.zeros_like(radius)]).expand(
        dir_row.shape
    )
    dist_row = raycast_atmosphere(atmo, origin_row, dir_row)
    a_r, a_m = _scattering_integral_components(atmo, transmittance_lut, origin_row, dir_row, dist_row)
    incident_cos = torch.sum(sun * (-direction), dim=-1)
    return phase_rayleigh(incident_cos)[..., None] * a_r + phase_mie(incident_cos, 0.8)[..., None] * a_m
