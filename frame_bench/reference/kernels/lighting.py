"""Deferred PBR lighting with 5x5 PCF shadow maps.

Port of ``syzygy_tpu/kernels/lighting.py`` (``deferred/lights.comp``,
``gbuffer/pbrFunctions.glinl``, ``shadowmap.glinl``). The PCF samples its
25 taps directly (``_sample_shadow_map_naive``, ``lighting.py:492-515``),
which is bitwise-equal to the reference's segment-table forms (the select
tree, ``bitmask``, ``window2d``, ``seg8``); with ``f16=True`` the map is
rounded to float16 before the compare, as the reference's f16 segment
tables are, up to 2048 texels (larger maps read f32 there). ``q8=True``
decodes the reference's u8 block-quantized segments.

Every light slot is evaluated, and each contributes under a mask computed
on the device (:func:`light_activity`, shared with the shadow pass): the
frame reads nothing back to the host, and the one form is differentiable
(autograd reaches the light colors and directions through the masked
sums; the reference needs its ``unroll=True`` form for that).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frame_bench.reference.device import constant
from frame_bench.reference.kernels.resolve import GBuffer
from frame_bench.reference.math.geometry import matmul4, matvec, sqrt_rn, vec_norm, world_up
from frame_bench.reference.scene.camera import CameraPacked
from frame_bench.reference.scene.lights import DirectionalLight, SpotLight

F32 = torch.float32
SPECULAR_POWER_BASE = 160.0
DIELECTRIC_F0 = 0.04
PI = 3.14159265359
_TO_TEX_COORD = (
    (0.5, 0.0, 0.0, 0.5),
    (0.0, 0.5, 0.0, 0.5),
    (0.0, 0.0, 1.0, 0.0),
    (0.0, 0.0, 0.0, 1.0),
)


class PBRTexel(NamedTuple):
    """``PBRTexel`` (``shaders/gbuffer/pbr.glinl``) over the pixel grid."""

    position: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor
    subscattering_color: torch.Tensor
    normal_reflectance: torch.Tensor
    occlusion: torch.Tensor  # (H, W, 1)
    specular_power: torch.Tensor
    metallic: torch.Tensor


def convert_pbr(gbuffer: GBuffer) -> PBRTexel:
    """``convertPBRProperties`` (``pbrFunctions.glinl:3-20``)."""
    spec_rgb = gbuffer.specular[..., :3]
    max3 = torch.amax(spec_rgb, dim=-1, keepdim=True)
    metallic_reflectance = 0.5 * spec_rgb / torch.clamp(max3, min=1e-8)
    metallic = gbuffer.orm[..., 2:3]
    roughness = gbuffer.orm[..., 1:2]
    return PBRTexel(
        position=gbuffer.world_position[..., :3],
        normal=gbuffer.normal[..., :3],
        subscattering_color=gbuffer.diffuse[..., :3],
        normal_reflectance=DIELECTRIC_F0 * (1.0 - metallic) + metallic_reflectance * metallic,
        occlusion=gbuffer.orm[..., 0:1],
        specular_power=torch.pow(SPECULAR_POWER_BASE, 1.0 - roughness),
        metallic=metallic,
    )


def _normalize(v, eps=1e-20):
    return v / sqrt_rn(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps))


def _dot1(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def compute_fresnel(material: PBRTexel, light_dir, view_dir):
    """``computeFresnel`` (``pbrFunctions.glinl:22-32``), Schlick."""
    halfway = _normalize(light_dir + view_dir)
    hl = torch.clamp(_dot1(halfway, light_dir), 0.0, 1.0)
    f0 = material.normal_reflectance
    return f0 + (1.0 - f0) * torch.pow(1.0 - hl, 5.0)


def diffuse_brdf(material: PBRTexel):
    """Lambert (``pbrFunctions.glinl:34-39``)."""
    return material.subscattering_color / PI


def specular_brdf(material: PBRTexel, light_dir, view_dir):
    """Normalized Blinn-Phong (``pbrFunctions.glinl:41-52``)."""
    halfway = _normalize(light_dir + view_dir)
    hn = torch.clamp(_dot1(halfway, material.normal), 0.0, 1.0)
    spec_power = material.specular_power
    out = (spec_power + 2.0) / 8.0 * torch.pow(hn, spec_power)
    return out.expand_as(material.subscattering_color)


def compute_shadow_frame(light_proj_view, position, normal):
    """``computeShadowFrame`` (``shadowmap.glinl:17-30``)."""
    m = matmul4(constant(_TO_TEX_COORD, F32, position.device), light_proj_view)
    ones = torch.ones_like(position[..., :1])
    coord = matvec(m, torch.cat([position, ones], dim=-1))
    w = coord[..., 3:4]
    coord = coord / torch.where(torch.abs(w) < 1e-8, 1e-8, w)
    pn = matvec(m, torch.cat([normal, torch.zeros_like(ones)], dim=-1))
    dx = sqrt_rn(1.0 - torch.clamp(pn[..., 0] * pn[..., 0], 0.0, 1.0))
    dy = sqrt_rn(1.0 - torch.clamp(pn[..., 1] * pn[..., 1], 0.0, 1.0))
    return coord, dx, dy


PCF_PAD = 8  # zero texels left of a segment row (``lighting.py:122``)
PCF_WINDOW_MAX_DIM = 2048  # larger maps take the direct f32 taps (``:125``)


def sample_shadow_map(
    shadow_map, coord, dx, dy, bitmask: bool = False, f16: bool = False, q8: bool = False,
    window2d: bool = False, seg8: bool = False,
):
    """``sampleShadowMap`` (``shadowmap.glinl:32-63``): 5x5 PCF, NEAREST,
    clamp-to-border(0), reverse-Z occluder test -> (H, W) light factor.

    The reference's precedence (``lighting.py:186-213``): above
    ``PCF_WINDOW_MAX_DIM`` texels the taps read the f32 map whatever the
    flags say; else ``q8`` decodes u8 segments (:func:`_pcf_q8`) and
    ``f16`` rounds the map. ``bitmask``, ``window2d`` and ``seg8`` are
    the reference's gather layouts of the same taps: accepted, and
    computed by the one direct form."""
    del bitmask, window2d, seg8  # layouts of the same taps
    size = shadow_map.shape[-1]
    if size <= PCF_WINDOW_MAX_DIM:
        if q8:
            return _pcf_q8(shadow_map, coord, dx, dy)
        if f16:
            shadow_map = shadow_map.to(torch.float16).to(F32)
    return _pcf_taps(size, coord, dx, dy, lambda iyc, ix: shadow_map[iyc, ix])


def directional_pcf(light, material: PBRTexel, shadow_map, **flags):
    """A directional light's (H, W) PCF visibility at the material's
    surface (``lights.comp:52-60``, ``camera.comp:349-356``); ``flags``
    are :func:`sample_shadow_map`'s."""
    coord, dx, dy = compute_shadow_frame(
        matmul4(light.projection, light.view), material.position, material.normal
    )
    return sample_shadow_map(shadow_map, coord, dx, dy, **flags)


def _pcf_taps(size: int, coord, dx, dy, texel):
    """The 25 taps: ``texel(row, column)`` reads the occluder depth at
    indices clamped into the map; taps outside it read 0
    (``lighting.py:492-515``)."""
    frag_depth = coord[..., 2]
    du = 1.5 * dx / size
    dv = 1.5 * dy / size
    u = coord[..., 0]
    v = coord[..., 1]
    occluded = torch.zeros_like(frag_depth)
    for oy in range(-2, 3):
        iy = torch.floor((v + oy * dv) * size).to(torch.int64)
        iyc = torch.clamp(iy, 0, size - 1)
        iy_in = (iy >= 0) & (iy < size)
        for ox in range(-2, 3):
            ix = torch.floor((u + ox * du) * size).to(torch.int64)
            inside = iy_in & (ix >= 0) & (ix < size)
            occ = torch.where(inside, texel(iyc, torch.clamp(ix, 0, size - 1)), 0.0)
            occluded += ((occ > 0.0) & (occ > frag_depth)).to(F32)
    return 1.0 - occluded / 25.0


def _pcf_q8(shadow_map, coord, dx, dy):
    """u8 block-scaled PCF segments (``lighting.py:419-489``). Each row of
    the map, zero-padded by ``PCF_PAD`` on the left, is cut into 16-texel
    segments at stride 8; a segment stores its taps as u8 fractions of its
    own depth range against the f16-rounded min and step. A tap row takes
    the one segment that holds all five of its taps (the reference's
    coverage bound: dx, dy <= 1) and decodes ``lo + q * step``, rounded
    after the product and again after the sum as the reference's op-by-op
    value is. The reference's u32 packing of the codes is its gather
    layout; the decoded taps are the same."""
    size = shadow_map.shape[-1]
    dev = shadow_map.device
    pad = PCF_PAD
    n_w = (size + 2 * pad) // 8
    padded = torch.zeros((size, n_w * 8 + 8), dtype=F32, device=dev)
    padded[:, pad : pad + size] = shadow_map
    seg_idx = (torch.arange(n_w, device=dev) * 8)[:, None] + torch.arange(16, device=dev)[None, :]
    windows = padded[:, seg_idx]  # (size, n_w, 16)
    lo = torch.amin(windows, dim=-1, keepdim=True)
    hi = torch.amax(windows, dim=-1, keepdim=True)
    lo16 = lo.to(torch.float16).to(F32)
    step16 = ((hi - lo) * torch.full((), 1.0 / 255.0, dtype=F32, device=dev)).to(torch.float16).to(F32)
    step = torch.clamp(step16, min=1e-30)
    codes = torch.clamp(torch.round((windows - lo16) / step), 0.0, 255.0).reshape(-1)
    lo16, step16 = lo16.reshape(-1), step16.reshape(-1)

    start = torch.floor(coord[..., 0] * size).to(torch.int64) - 3 + pad  # leftmost tap, padded
    w = torch.clamp(torch.div(start, 8, rounding_mode="floor"), 0, n_w - 1)

    def texel(iyc, ix):
        seg = iyc * n_w + w
        c = torch.clamp(ix + pad - 8 * w, 0, 15)  # the tap's channel in its segment
        scaled = codes[seg * 16 + c] * step16[seg]
        return lo16[seg] + scaled  # two roundings, no fused multiply-add

    return _pcf_taps(size, coord, dx, dy, texel)


def _light_contribution(material, view_dir, light_dir, spectral):
    """``computeLightContribution`` (``lights.comp:93-108``)."""
    fresnel = compute_fresnel(material, light_dir, view_dir)
    brdf = diffuse_brdf(material) * (1.0 - fresnel) + specular_brdf(
        material, light_dir, view_dir
    ) * fresnel
    nl = torch.clamp(_dot1(material.normal, light_dir), 0.0, 1.0)
    return material.occlusion * brdf * spectral * nl


class LightActivity(NamedTuple):
    """Which lights contribute this frame: per-slot masks on the lights'
    device, so that nothing is read back to the host."""

    shadowed_dirs: torch.Tensor  # (D,) bool: directional slots lit with their shadow map
    unshadowed_dirs: torch.Tensor  # (D,) bool: directional slots lit without PCF (dim gate)
    spots: torch.Tensor  # (S,) bool: active spot slots
    shadow_maps: torch.Tensor  # (min(n_shadow_maps, D + S),) bool: map slots the shadow pass rasters


def light_activity(
    directional: DirectionalLight, directional_count, directional_skip,
    spots: SpotLight, spot_count, shadowless_eps: float, n_shadow_maps: int,
) -> LightActivity:
    """Which lights contribute this frame, and which maps need a raster.

    Directional light i lights the frame when ``skip <= i < count`` and
    its color*strength is nonzero (an exactly-zero light is skipped
    bitwise-exactly). With ``shadowless_eps > 0`` a light whose peak
    intensity is below eps times the frame's daylight-weighted total
    contributes unshadowed (``lighting.py:605-619``, the relative gate).
    The shadow pass rasters map 0 (the sun; the sky pass samples it), the
    directional maps the gate keeps, and every spot map up to
    ``n_shadow_maps`` of ``2 + spot_count`` (``frame.py:544-574``). The
    counts are device scalars; every mask is computed on their device."""
    n_dir = directional.strength.shape[0]
    n_spot = spots.strength.shape[0]
    dev = directional.strength.device
    dir_int = torch.amax(torch.abs(directional.color[:, :3]), dim=-1) * torch.abs(directional.strength)
    if shadowless_eps > 0.0:
        daylight = torch.clamp(
            torch.sum(-directional.forward[:, :3] * world_up(dev), dim=-1), 0.0, 1.0
        )
        needs_pcf = dir_int >= shadowless_eps * torch.sum(dir_int * daylight)
    else:
        needs_pcf = dir_int != 0.0
    emits = (torch.amax(torch.abs(directional.color[:, :3]), dim=-1) * directional.strength) != 0.0
    s_emits = (torch.amax(torch.abs(spots.color[:, :3]), dim=-1) * spots.strength) != 0.0
    ids = torch.arange(n_dir, device=dev)
    live = (ids >= directional_skip) & (ids < directional_count) & emits
    if shadowless_eps > 0.0:
        shadowed, unshadowed = live & needs_pcf, live & ~needs_pcf
    else:
        shadowed, unshadowed = live, torch.zeros_like(live)
    slots = torch.arange(min(n_shadow_maps, n_dir + n_spot), device=dev)
    gated = torch.cat([needs_pcf | (ids == 0), torch.ones(n_spot, dtype=torch.bool, device=dev)])
    return LightActivity(
        shadowed_dirs=shadowed,
        unshadowed_dirs=unshadowed,
        spots=(torch.arange(n_spot, device=dev) < spot_count) & s_emits,
        shadow_maps=(slots < n_dir + spot_count) & gated[: slots.shape[0]],
    )


def _take(light, i):
    return type(light)(*[x[i] for x in light])


def deferred_lighting(
    gbuffer: GBuffer,
    camera: CameraPacked,
    directional: DirectionalLight,
    directional_count,  # i32 device scalars, as the reference takes them
    directional_skip,
    spots: SpotLight,
    spot_count,
    shadow_maps,  # (D + S, dim, dim) f32
    unroll: bool = False,
    pcf_bitmask: bool = False,
    pcf_f16: bool = False,
    pcf_q8: bool = False,
    pcf_window2d: bool = False,
    shadowless_eps: float = 0.0,
    sun_shadow=None,
):
    """``deferred/lights.comp`` main loop -> (H, W, 3) linear color
    (``lighting.py:528-791``), with the reference's signature. Background
    texels (diffuse alpha < 1) stay black. Shadowed directionals
    accumulate first, then the dim ones without PCF (``shadowless_eps``,
    :func:`light_activity`'s gate), then spots — the reference's order.
    Every slot is evaluated and accumulated under its device mask
    (``acc = where(active, acc + c, acc)``), so an inactive light leaves
    the sum bitwise as it was and nothing is read back to the host; this
    one form is differentiable (``unroll``, the reference's differentiable
    form, is accepted and changes nothing). The ``pcf_*`` flags go to
    :func:`sample_shadow_map`. ``sun_shadow`` (H, W), when given, is
    directional light 0's PCF, evaluated once by the caller and shared
    with the sky pass (``RenderConfig.share_sun_pcf``); it takes the place
    of that light's own PCF in the same accumulation order."""
    del unroll  # one form
    activity = light_activity(
        directional, directional_count, directional_skip, spots, spot_count, shadowless_eps,
        shadow_maps.shape[0],
    )
    material = convert_pbr(gbuffer)
    lit_mask = gbuffer.diffuse[..., 3:4] >= 1.0
    view_dir = _normalize(camera.position[:3] - material.position)
    total = torch.zeros_like(material.position)
    n_dir = directional.strength.shape[0]
    pcf = dict(bitmask=pcf_bitmask, f16=pcf_f16, q8=pcf_q8, window2d=pcf_window2d)

    def dir_contribution(i, shadow):
        light = _take(directional, i)
        light_dir = _normalize(-light.forward[:3])
        spectral = (light.color[:3] * light.strength) * shadow[..., None]
        return _light_contribution(material, view_dir, light_dir, spectral)

    for i in range(n_dir):
        if i == 0 and sun_shadow is not None:
            shadow = sun_shadow
        else:
            shadow = directional_pcf(_take(directional, i), material, shadow_maps[i], **pcf)
        total = torch.where(activity.shadowed_dirs[i], total + dir_contribution(i, shadow), total)
    if shadowless_eps > 0.0:
        ones = torch.ones_like(material.position[..., 0])
        for i in range(n_dir):
            total = torch.where(activity.unshadowed_dirs[i], total + dir_contribution(i, ones), total)

    for j in range(spots.strength.shape[0]):
        spot = _take(spots, j)
        coord, dx, dy = compute_shadow_frame(matmul4(spot.projection, spot.view), material.position, material.normal)
        shadow = sample_shadow_map(shadow_maps[n_dir + j], coord, dx, dy, **pcf)
        light_dir = _normalize(-spot.forward[:3])
        # quadratic falloff + UV edge softening (lights.comp:73-91)
        dist = vec_norm(spot.position[:3] - material.position, dim=-1, keepdim=True)
        norm_dist = dist / spot.falloff_distance
        falloff = spot.falloff_factor * norm_dist * norm_dist
        uv_dist = torch.clamp(
            vec_norm(coord[..., :2] - 0.5, dim=-1, keepdim=True) / 0.5, 0.0, 1.0
        )
        edge_soften = 1.0 - uv_dist * uv_dist
        spectral = (
            (spot.color[:3] * spot.strength) / torch.clamp(falloff, min=1e-8)
            * edge_soften * shadow[..., None]
        )
        contribution = _light_contribution(material, view_dir, light_dir, spectral)
        total = torch.where(activity.spots[j], total + contribution, total)
    return torch.where(lit_mask, total, 0.0)
