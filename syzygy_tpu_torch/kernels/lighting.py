"""Deferred PBR lighting with 5x5 PCF shadow maps.

Port of ``syzygy_tpu/kernels/lighting.py`` (``deferred/lights.comp``,
``gbuffer/pbrFunctions.glinl``, ``shadowmap.glinl``). The PCF samples its
25 taps directly (``_sample_shadow_map_naive``, ``lighting.py:492-515``),
which is bitwise-equal to the reference's segment-table form; with
``f16=True`` the map is rounded to float16 before the compare, as the
reference's f16 segment tables are.

Light loops run only over lights that can contribute. Which lights those
are is decided on the host from one small device->host copy per frame
(:func:`light_activity`), shared with the shadow pass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from syzygy_tpu_torch.kernels.resolve import GBuffer
from syzygy_tpu_torch.math.geometry import matmul4, matvec, sqrt_rn, vec_norm, world_up
from syzygy_tpu_torch.scene.camera import CameraPacked
from syzygy_tpu_torch.scene.lights import DirectionalLight, SpotLight

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
    m = matmul4(torch.tensor(_TO_TEX_COORD, dtype=F32, device=position.device), light_proj_view)
    ones = torch.ones_like(position[..., :1])
    coord = matvec(m, torch.cat([position, ones], dim=-1))
    w = coord[..., 3:4]
    coord = coord / torch.where(torch.abs(w) < 1e-8, 1e-8, w)
    pn = matvec(m, torch.cat([normal, torch.zeros_like(ones)], dim=-1))
    dx = sqrt_rn(1.0 - torch.clamp(pn[..., 0] * pn[..., 0], 0.0, 1.0))
    dy = sqrt_rn(1.0 - torch.clamp(pn[..., 1] * pn[..., 1], 0.0, 1.0))
    return coord, dx, dy


def sample_shadow_map(shadow_map, coord, dx, dy, f16: bool = False):
    """``sampleShadowMap`` (``shadowmap.glinl:32-63``): 5x5 PCF, NEAREST,
    clamp-to-border(0), reverse-Z occluder test -> (H, W) light factor."""
    size = shadow_map.shape[-1]
    if f16:
        shadow_map = shadow_map.to(torch.float16).to(F32)
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
            occ = torch.where(inside, shadow_map[iyc, torch.clamp(ix, 0, size - 1)], 0.0)
            occluded += ((occ > 0.0) & (occ > frag_depth)).to(F32)
    return 1.0 - occluded / 25.0


def _light_contribution(material, view_dir, light_dir, spectral):
    """``computeLightContribution`` (``lights.comp:93-108``)."""
    fresnel = compute_fresnel(material, light_dir, view_dir)
    brdf = diffuse_brdf(material) * (1.0 - fresnel) + specular_brdf(
        material, light_dir, view_dir
    ) * fresnel
    nl = torch.clamp(_dot1(material.normal, light_dir), 0.0, 1.0)
    return material.occlusion * brdf * spectral * nl


class LightActivity(NamedTuple):
    """Host-side light selection for one frame (from one D2H copy)."""

    shadowed_dirs: list  # directional slots lit with their shadow map
    unshadowed_dirs: list  # directional slots lit without PCF (dim gate)
    spots: list  # active spot slots
    shadow_maps: list  # map slots the shadow pass rasters


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
    ``n_shadow_maps`` of ``2 + spot_count`` (``frame.py:544-574``)."""
    n_dir = directional.strength.shape[0]
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
    host = torch.cat(
        [
            needs_pcf.to(torch.int32),
            emits.to(torch.int32),
            s_emits.to(torch.int32),
            torch.stack([directional_count, directional_skip, spot_count]).to(torch.int32),
        ]
    ).tolist()
    n_spot = s_emits.shape[0]
    needs = host[:n_dir]
    dir_emits = host[n_dir : 2 * n_dir]
    spot_emits = host[2 * n_dir : 2 * n_dir + n_spot]
    count, skip, n_spots_live = host[2 * n_dir + n_spot :]
    live = [i for i in range(n_dir) if skip <= i < count and dir_emits[i]]
    if shadowless_eps > 0.0:
        shadowed = [i for i in live if needs[i]]
        unshadowed = [i for i in live if not needs[i]]
    else:
        shadowed, unshadowed = live, []
    maps = [
        i for i in range(min(n_shadow_maps, n_dir + n_spots_live))
        if i >= n_dir or i == 0 or needs[i]
    ]
    return LightActivity(
        shadowed_dirs=shadowed,
        unshadowed_dirs=unshadowed,
        spots=[j for j in range(n_spot) if j < n_spots_live and spot_emits[j]],
        shadow_maps=maps,
    )


def _take(light, i):
    return type(light)(*[x[i] for x in light])


def deferred_lighting(
    gbuffer: GBuffer,
    camera: CameraPacked,
    directional: DirectionalLight,
    spots: SpotLight,
    shadow_maps,  # (D + S, dim, dim) f32
    activity: LightActivity,
    pcf_f16: bool = False,
):
    """``deferred/lights.comp`` main loop -> (H, W, 3) linear color
    (``lighting.py:528-791``). Background texels (diffuse alpha < 1) stay
    black. Shadowed directionals accumulate first, then the dim ones
    without PCF, then spots — the reference's order."""
    material = convert_pbr(gbuffer)
    lit_mask = gbuffer.diffuse[..., 3:4] >= 1.0
    view_dir = _normalize(camera.position[:3] - material.position)
    total = torch.zeros_like(material.position)
    n_dir = directional.strength.shape[0]

    def dir_contribution(i, shadow):
        light = _take(directional, i)
        light_dir = _normalize(-light.forward[:3])
        spectral = (light.color[:3] * light.strength) * shadow[..., None]
        return _light_contribution(material, view_dir, light_dir, spectral)

    for i in activity.shadowed_dirs:
        light = _take(directional, i)
        coord, dx, dy = compute_shadow_frame(matmul4(light.projection, light.view), material.position, material.normal)
        total = total + dir_contribution(i, sample_shadow_map(shadow_maps[i], coord, dx, dy, f16=pcf_f16))
    for i in activity.unshadowed_dirs:
        total = total + dir_contribution(i, torch.ones_like(material.position[..., 0]))

    for j in activity.spots:
        spot = _take(spots, j)
        coord, dx, dy = compute_shadow_frame(matmul4(spot.projection, spot.view), material.position, material.normal)
        shadow = sample_shadow_map(shadow_maps[n_dir + j], coord, dx, dy, f16=pcf_f16)
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
        total = total + _light_contribution(material, view_dir, light_dir, spectral)
    return torch.where(lit_mask, total, 0.0)
