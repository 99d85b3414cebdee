"""Deferred PBR lighting with 5x5 PCF shadow maps.

Port of ``syzygy_tpu/kernels/lighting.py`` (``deferred/lights.comp``,
``gbuffer/pbrFunctions.glinl``, ``shadowmap.glinl``). The PCF samples its
25 taps directly (``_sample_shadow_map_naive``, ``lighting.py:492-515``),
which is bitwise-equal to the reference's segment-table gather layouts
(the select tree, ``bitmask``, ``window2d``, ``seg8``), which the port
does not have; with ``f16=True`` the map is
rounded to float16 before the compare, as the reference's f16 segment
tables are, up to 2048 texels (larger maps read f32 there). ``q8=True``
decodes the reference's u8 block-quantized segments.

Which light slots contribute is a mask computed on the device
(:func:`light_activity`, shared with the shadow pass), so the frame reads
nothing back to the host. :func:`deferred_lighting` takes one of two
forms by its inputs' device: on CUDA tensors it launches
``csrc/lighting.cu``, one thread per pixel that evaluates only the live
slots, bitwise :func:`deferred_lighting_plain`; on the CPU it runs
:func:`deferred_lighting_plain`, which evaluates every slot and keeps each
under its mask (autograd reaches the light colors and directions through
the masked sums; the reference needs its ``unroll=True`` form for that).
On the card, inputs that need a gradient get the plain version's.
``kernels.build.LAUNCHES`` counts the kernel's launches (``lighting``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from syzygy_tpu_torch.device import constant
from syzygy_tpu_torch.kernels import build
from syzygy_tpu_torch.kernels.plain_gradient import dispatch
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


def sample_shadow_map(shadow_map, coord, dx, dy, f16: bool = False, q8: bool = False):
    """``sampleShadowMap`` (``shadowmap.glinl:32-63``): 5x5 PCF, NEAREST,
    clamp-to-border(0), reverse-Z occluder test -> (H, W) light factor.

    The reference's precedence (``lighting.py:186-213``): above
    ``PCF_WINDOW_MAX_DIM`` texels the taps read the f32 map whatever the
    flags say; else ``q8`` decodes u8 segments (:func:`_pcf_q8`) and
    ``f16`` rounds the map."""
    size = shadow_map.shape[-1]
    if size <= PCF_WINDOW_MAX_DIM:
        if q8:
            return _pcf_q8(shadow_map, coord, dx, dy)
        if f16:
            shadow_map = shadow_map.to(torch.float16).to(F32)
    return _pcf_taps(size, coord, dx, dy, lambda iyc, ix: shadow_map[iyc, ix])


def directional_pcf(light, material: PBRTexel, shadow_map, f16: bool = False, q8: bool = False):
    """A directional light's (H, W) PCF visibility at the material's
    surface (``lights.comp:52-60``, ``camera.comp:349-356``); ``f16`` and
    ``q8`` as :func:`sample_shadow_map` takes them."""
    coord, dx, dy = compute_shadow_frame(
        matmul4(light.projection, light.view), material.position, material.normal
    )
    return sample_shadow_map(shadow_map, coord, dx, dy, f16=f16, q8=q8)


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


def _q8_segments(shadow_map):
    """The u8 block-scaled PCF segments of one (size, size) map
    (``lighting.py:419-489``). Each row of the map, zero-padded by
    ``PCF_PAD`` on the left, is cut into ``n_w`` 16-texel segments at
    stride 8; a segment stores its taps as u8 fractions of its own depth
    range against the f16-rounded min and step. Returns the codes (size *
    n_w * 16,) as f32 integers, the segments' ``lo16`` and ``step16``
    (size * n_w,) and ``n_w``."""
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
    return codes, lo16.reshape(-1), step16.reshape(-1), n_w


def _pcf_q8(shadow_map, coord, dx, dy):
    """PCF over :func:`_q8_segments`. A tap row takes the one segment that
    holds all five of its taps (the reference's coverage bound: dx, dy <=
    1) and decodes ``lo + q * step``, rounded after the product and again
    after the sum as the reference's op-by-op value is. The reference's
    u32 packing of the codes is its gather layout; the decoded taps are
    the same."""
    size = shadow_map.shape[-1]
    pad = PCF_PAD
    codes, lo16, step16, n_w = _q8_segments(shadow_map)

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


def deferred_lighting_plain(
    gbuffer: GBuffer,
    camera: CameraPacked,
    directional: DirectionalLight,
    directional_count,  # i32 device scalars, as the reference takes them
    directional_skip,
    spots: SpotLight,
    spot_count,
    shadow_maps,  # (D + S, dim, dim) f32
    pcf_f16: bool = False,
    pcf_q8: bool = False,
    shadowless_eps: float = 0.0,
    sun_shadow=None,
):
    """``deferred/lights.comp`` main loop -> (H, W, 3) linear color
    (``lighting.py:528-791``), with the reference's signature, in tensor
    operations over the whole target. Background
    texels (diffuse alpha < 1) stay black. Shadowed directionals
    accumulate first, then the dim ones without PCF (``shadowless_eps``,
    :func:`light_activity`'s gate), then spots — the reference's order.
    Every slot is evaluated and accumulated under its device mask
    (``acc = where(active, acc + c, acc)``), so an inactive light leaves
    the sum bitwise as it was and nothing is read back to the host; this
    one form is differentiable, as the reference's ``unroll=True`` form
    is. The ``pcf_*`` flags go to
    :func:`sample_shadow_map`. ``sun_shadow`` (H, W), when given, is
    directional light 0's PCF, evaluated once by the caller and shared
    with the sky pass (``RenderConfig.share_sun_pcf``); it takes the place
    of that light's own PCF in the same accumulation order."""
    activity = light_activity(
        directional, directional_count, directional_skip, spots, spot_count, shadowless_eps,
        shadow_maps.shape[0],
    )
    material = convert_pbr(gbuffer)
    lit_mask = gbuffer.diffuse[..., 3:4] >= 1.0
    view_dir = _normalize(camera.position[:3] - material.position)
    total = torch.zeros_like(material.position)
    n_dir = directional.strength.shape[0]
    pcf = dict(f16=pcf_f16, q8=pcf_q8)

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


TABLE_STRIDE = 32  # f32 values per light slot of :func:`light_table` (csrc/lighting.cu)
MAX_SLOTS = 64  # light slots the kernel's evaluated-slot mask holds
_LAST_MASK: dict = {}  # device -> the slot mask its last lighting launch writes


def light_table(directional: DirectionalLight, spots: SpotLight) -> torch.Tensor:
    """What the kernel reads of each light slot, (D + S, TABLE_STRIDE) f32
    on the lights' device, directional slots first: the shadow frame's
    matrix ``matmul4(_TO_TEX_COORD, matmul4(projection, view))`` (16,
    row-major), ``_normalize(-forward[:3])``, ``color[:3] * strength``,
    and for spots ``position[:3]``, ``falloff_factor`` and
    ``falloff_distance`` (zeros for directional slots). The plain
    version's functions over all slots at once: each value is bitwise the
    one :func:`deferred_lighting_plain` computes for its slot."""
    dev = directional.strength.device
    n_dir, n_spot = directional.strength.shape[0], spots.strength.shape[0]
    proj_view = torch.cat([matmul4(directional.projection, directional.view), matmul4(spots.projection, spots.view)])
    frames = matmul4(constant(_TO_TEX_COORD, F32, dev), proj_view).reshape(-1, 16)
    forward = torch.cat([directional.forward[:, :3], spots.forward[:, :3]])
    spectral = torch.cat([
        directional.color[:, :3] * directional.strength[:, None], spots.color[:, :3] * spots.strength[:, None],
    ])
    spot_only = torch.cat([
        torch.zeros((n_dir, 5), dtype=F32, device=dev),
        torch.cat([spots.position[:, :3], spots.falloff_factor[:, None], spots.falloff_distance[:, None]], dim=1),
    ])
    pad = torch.zeros((n_dir + n_spot, TABLE_STRIDE - 27), dtype=F32, device=dev)
    return torch.cat([frames, _normalize(-forward), spectral, spot_only, pad], dim=1)


def q8_tables(shadow_maps):
    """Every slot's :func:`_q8_segments`, as the kernel reads them: the
    codes (D + S, size * n_w * 16) in f16 (integers 0-255, or NaN where
    the plain version's are, all exact in f16), ``lo16`` and ``step16``
    (D + S, size * n_w) f32, and ``n_w``; one map at a time, so that the
    temporaries are one map's."""
    n_maps, size = shadow_maps.shape[0], shadow_maps.shape[-1]
    n_w = (size + 2 * PCF_PAD) // 8
    dev = shadow_maps.device
    codes = torch.empty((n_maps, size * n_w * 16), dtype=torch.float16, device=dev)
    lo16 = torch.empty((n_maps, size * n_w), dtype=F32, device=dev)
    step16 = torch.empty_like(lo16)
    for m in range(n_maps):
        codes[m], lo16[m], step16[m], _ = _q8_segments(shadow_maps[m])
    return codes, lo16, step16, n_w


def last_slot_mask(device) -> torch.Tensor | None:
    """The int64 mask that the last lighting launch on ``device`` writes
    (bit k: some pixel evaluated light slot k), or None before any launch
    there. A launch captured into a CUDA graph writes its own mask on
    every replay (``renderer/frame.py`` keeps it with the graph)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _LAST_MASK.get(device)


def evaluated_slots(mask: torch.Tensor | None) -> int | None:
    """The number of light slots a mask of :func:`last_slot_mask` holds (a
    host read of one device int64), or None for no mask."""
    return None if mask is None else bin(int(mask) & (1 << MAX_SLOTS) - 1).count("1")


def _pixels(plane: torch.Tensor, shape, what: str) -> torch.Tensor:
    """A contiguous f32 tensor of ``shape`` that starts on a 16-byte
    boundary (the kernel reads a G-buffer texel as one float4)."""
    if plane.dtype != F32 or tuple(plane.shape) != tuple(shape):
        raise ValueError(f"{what} must be a {tuple(shape)} float32 tensor, got {tuple(plane.shape)} {plane.dtype}")
    plane = plane.contiguous()
    return plane.clone() if plane.data_ptr() % 16 else plane


def _launch_kernel(gbuffer, camera, directional, spots, shadow_maps, shadowless_eps, activity, f16, q8, sun_shadow):
    """Launch ``csrc/lighting.cu`` over the G-buffer's (rows, W) pixels,
    its taps rounded to f16 (``f16``) or decoded from q8 segments
    (``q8``)."""
    rows, width = gbuffer.diffuse.shape[:2]
    dev = shadow_maps.device
    n_dir, n_spot = directional.strength.shape[0], spots.strength.shape[0]
    size = shadow_maps.shape[-1]
    if n_dir + n_spot > MAX_SLOTS:
        raise ValueError(f"the lighting kernel takes at most {MAX_SLOTS} light slots, got {n_dir + n_spot}")
    if shadow_maps.dtype != F32 or tuple(shadow_maps.shape) != (n_dir + n_spot, size, size):
        raise ValueError(f"shadow maps must be ({n_dir + n_spot}, dim, dim) float32, got {tuple(shadow_maps.shape)}")
    planes = [_pixels(p, (rows, width, 4), f"G-buffer plane {name}") for name, p in zip(GBuffer._fields, gbuffer)]
    if sun_shadow is not None:
        sun_shadow = _pixels(sun_shadow, (rows, width), "sun_shadow")
    if any(m.dtype != torch.bool for m in activity[:3]):
        raise ValueError("the light masks must be bool")
    tensors = [*planes, camera.position, shadow_maps, *activity[:3]] + ([sun_shadow] if sun_shadow is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("the G-buffer, camera, light masks and shadow maps must be on one device")
    table = light_table(directional, spots)
    camera_pos = camera.position[:3].contiguous()
    maps = shadow_maps.contiguous()
    masks = [m.contiguous() for m in activity[:3]]
    codes, lo16, step16, n_w = q8_tables(maps) if q8 else (None, None, None, 0)
    mask = torch.empty((), dtype=torch.int64, device=dev)
    out = torch.empty((rows, width, 3), dtype=F32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch(
        "szg_lighting", dev,
        *[p.data_ptr() for p in planes], camera_pos.data_ptr(), table.data_ptr(), *[m.data_ptr() for m in masks],
        n_dir, n_spot, int(shadowless_eps > 0.0), maps.data_ptr(), size, int(f16), ptr(codes), ptr(lo16),
        ptr(step16), n_w, ptr(sun_shadow), out.data_ptr(), mask.data_ptr(), rows * width, counts={"lighting": 1},
    )
    _LAST_MASK[dev] = mask
    return out


def deferred_lighting(
    gbuffer: GBuffer,
    camera: CameraPacked,
    directional: DirectionalLight,
    directional_count,  # i32 device scalars, as the reference takes them
    directional_skip,
    spots: SpotLight,
    spot_count,
    shadow_maps,  # (D + S, dim, dim) f32
    pcf_f16: bool = False,
    pcf_q8: bool = False,
    shadowless_eps: float = 0.0,
    sun_shadow=None,
):
    """:func:`deferred_lighting_plain`'s lighting, with its signature and
    its bits. On CUDA tensors it launches ``csrc/lighting.cu`` once: one
    thread per pixel, every intermediate in registers, only the slots
    :func:`light_activity` marks live evaluated (in the plain version's
    order), their per-slot inputs packed by :func:`light_table`, q8 maps'
    segments by :func:`q8_tables`. Where autograd needs the inputs, the
    gradient is the plain version's (:func:`kernels.plain_gradient.dispatch`). CPU tensors
    take :func:`deferred_lighting_plain`."""
    args = (
        gbuffer, camera, directional, directional_count, directional_skip, spots, spot_count, shadow_maps,
        sun_shadow,
    )

    def plain(*a):
        return deferred_lighting_plain(
            *a[:-1], pcf_f16=pcf_f16, pcf_q8=pcf_q8, shadowless_eps=shadowless_eps, sun_shadow=a[-1],
        )

    def kernel():
        activity = light_activity(
            directional, directional_count, directional_skip, spots, spot_count, shadowless_eps,
            shadow_maps.shape[0],
        )
        small = shadow_maps.shape[-1] <= PCF_WINDOW_MAX_DIM
        return _launch_kernel(
            gbuffer, camera, directional, spots, shadow_maps, shadowless_eps, activity,
            pcf_f16 and small, pcf_q8 and small, sun_shadow,
        )

    return dispatch(shadow_maps.device, kernel, plain, args)
