"""G-buffer resolve: visibility buffer -> shaded attribute planes.

Port of ``syzygy_tpu/kernels/resolve.py`` (single-mip path): per-clipped-
triangle attribute records are joined once per frame
(:func:`build_resolve_records`), then each pixel gathers its record through
the visibility buffer's slot id, interpolates perspective-correctly,
samples the plain texture atlas (bilinear, REPEAT inside each texture's
rect) and perturbs the normal with the analytic cotangent frame
(``offscreen.frag:25-59``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from syzygy_tpu_torch.kernels.raster import TriSetup, VisibilityBuffer
from syzygy_tpu_torch.math.geometry import matvec, matvec_fma, sqrt_rn, vec_norm
from syzygy_tpu_torch.scene.pack import GeometryStatic

F32 = torch.float32
RECORD_WIDTH = 49


class GBuffer(NamedTuple):
    """5-plane G-buffer (``renderer/gbuffer.cpp:27-44``)."""

    diffuse: torch.Tensor  # (H, W, 4)
    specular: torch.Tensor
    normal: torch.Tensor
    world_position: torch.Tensor
    orm: torch.Tensor


def _norm(v, eps=1e-20):
    return torch.clamp(vec_norm(v, keepdim=True), min=eps)


def transform_positions(positions, vert_instance, models, proj_view):
    """Vertex stage (``offscreen.vert:41-51``): (clip (V, 4), world (V, 3))."""
    m = models[vert_instance.long()]
    pos_h = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=-1)
    world = matvec_fma(m, pos_h)
    return matvec(proj_view, world), world[:, :3]


def transform_normals(normals, vert_instance, model_inv_transpose):
    """``offscreen.vert:53``: normalize((modelInverseTranspose * n).xyz)."""
    m = model_inv_transpose[vert_instance.long()][:, :3, :3]
    n = matvec_fma(m, normals)
    return n / _norm(n)


def sample_atlas_rect(r: torch.Tensor, atlas: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear + REPEAT sample inside per-sample rects ``r`` (..., 4) i64
    [x0, y0, w, h] of the plain (A_h, A_w, 4) atlas; texels widen to f32
    before filtering (``resolve.py:128-159``). ``torch.remainder`` is the
    floor-mod of ``jnp.mod`` (``fmod`` differs for negatives)."""
    x0r, y0r, w, h = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    p_x = uv[..., 0] * w.to(F32) - 0.5
    p_y = uv[..., 1] * h.to(F32) - 0.5
    fx0 = torch.floor(p_x)
    fy0 = torch.floor(p_y)
    fracx = (p_x - fx0)[..., None]
    fracy = (p_y - fy0)[..., None]
    ix0 = torch.remainder(fx0.to(torch.int64), w)
    iy0 = torch.remainder(fy0.to(torch.int64), h)
    ix1 = torch.where(ix0 + 1 >= w, 0, ix0 + 1)
    iy1 = torch.where(iy0 + 1 >= h, 0, iy0 + 1)
    t00 = atlas[y0r + iy0, x0r + ix0].to(F32)
    t10 = atlas[y0r + iy0, x0r + ix1].to(F32)
    t01 = atlas[y0r + iy1, x0r + ix0].to(F32)
    t11 = atlas[y0r + iy1, x0r + ix1].to(F32)
    top = t00 * (1.0 - fracx) + t10 * fracx
    bot = t01 * (1.0 - fracx) + t11 * fracx
    return top * (1.0 - fracy) + bot * fracy


def _cotangent_frame_normal(n, dp1, dp2, duv1, duv2, normal_map):
    """``cotangentFrame`` + ``perturbNormal`` (``offscreen.frag:25-59``)."""
    dp2perp = torch.linalg.cross(dp2, n)
    dp1perp = torch.linalg.cross(n, dp1)
    t = dp2perp * duv1[..., 0:1] + dp1perp * duv2[..., 0:1]
    b = dp2perp * duv1[..., 1:2] + dp1perp * duv2[..., 1:2]
    invmax = 1.0 / sqrt_rn(
        torch.clamp(
            torch.maximum(
                torch.sum(t * t, dim=-1, keepdim=True),
                torch.sum(b * b, dim=-1, keepdim=True),
            ),
            min=1e-20,
        )
    )
    perturbed = (
        t * invmax * normal_map[..., 0:1]
        + b * invmax * normal_map[..., 1:2]
        + n * normal_map[..., 2:3]
    )
    return perturbed / _norm(perturbed)


def build_resolve_records(setup: TriSetup, geometry: GeometryStatic, world_positions, world_normals):
    """Pre-joined per-slot attribute records, (T2pad, 49) f32
    (``resolve.py:303-460``).

    Layout: 0:3 corner w | 3:12 corner world pos | 12:21 corner normals |
    21:27 corner uvs | 27:30 dp1 | 30:33 dp2 | 33:35 duv1 | 35:37 duv2 |
    37:49 color/normal/orm atlas rects (small ints, exact in f32). Slot t
    and T+t share original triangle t; pad slots keep corner_w == 1 so
    background pixels (which gather some record) make no 0/0."""
    t2_pad = setup.orig_tri.shape[0]
    tris = geometry.triangles.long()
    n_t = tris.shape[0]

    def tile2(x):
        return torch.cat([x, x], dim=0)

    p = tile2(world_positions[tris])  # (2T, 3, 3)
    n = tile2(world_normals[tris])
    u = tile2(geometry.uvs[tris])
    cb = setup.corner_bary[: 2 * n_t]
    w3 = torch.cat([cb, 1.0 - cb[..., 0:1] - cb[..., 1:2]], dim=-1)
    # clipped corners' attributes: c[t, k] = sum_j w3[t, k, j] * attr[t, j]
    cp = matvec_fma(p.transpose(1, 2)[:, None], w3)  # (2T, 3, 3)
    cn = matvec_fma(n.transpose(1, 2)[:, None], w3)
    cu = matvec_fma(u.transpose(1, 2)[:, None], w3)  # (2T, 3, 2)
    t2 = 2 * n_t
    rects = tile2(geometry.tex_rects[geometry.materials[geometry.tri_material.long()].long()])
    rows = torch.cat(
        [
            setup.corner_w[: 2 * n_t],
            cp.reshape(t2, 9),
            cn.reshape(t2, 9),
            cu.reshape(t2, 6),
            p[:, 1] - p[:, 0],
            p[:, 2] - p[:, 0],
            u[:, 1] - u[:, 0],
            u[:, 2] - u[:, 0],
            rects.reshape(t2, 12).to(F32),
        ],
        dim=-1,
    )
    pad = t2_pad - t2
    if pad:
        pad_rows = torch.cat(
            [
                torch.ones((pad, 3), dtype=F32, device=rows.device),
                torch.zeros((pad, RECORD_WIDTH - 3), dtype=F32, device=rows.device),
            ],
            dim=-1,
        )
        rows = torch.cat([rows, pad_rows], dim=0)
    return rows


def resolve_gbuffer_from_records(vis: VisibilityBuffer, records, geometry: GeometryStatic) -> GBuffer:
    """Per-pixel tail of the resolve (``resolve.py:486-568``): one record
    gather, perspective-correct interpolation, three atlas samples."""
    valid = vis.tri >= 0
    tid = torch.clamp(vis.tri, min=0).long()
    rec = records[tid]  # (H, W, 49)
    hw = tid.shape

    corner_w = rec[..., 0:3]
    sb = torch.stack([vis.b0, vis.b1, 1.0 - vis.b0 - vis.b1], dim=-1)
    pc = sb / torch.clamp(corner_w, min=1e-8)
    pc = pc / torch.clamp(torch.sum(pc, dim=-1, keepdim=True), min=1e-20)

    def interp(lo, c):
        block = rec[..., lo : lo + 3 * c].reshape(*hw, 3, c)
        return matvec_fma(block.transpose(-1, -2), pc)

    position = interp(3, 3)
    normal_geo = interp(12, 3)
    normal_geo = normal_geo / _norm(normal_geo)
    uv = interp(21, 2)

    atlas = geometry.tex_atlas
    rects = rec[..., 37:49].to(torch.int64)
    color_tex = sample_atlas_rect(rects[..., 0:4], atlas, uv)
    normal_tex = sample_atlas_rect(rects[..., 4:8], atlas, uv)
    orm_tex = sample_atlas_rect(rects[..., 8:12], atlas, uv)

    # normal map decode (offscreen.frag:50-55): unsigned -> signed, green-up
    nmap = normal_tex[..., :3] * (255.0 / 127.0) - (128.0 / 127.0)
    nmap = nmap * torch.tensor([1.0, -1.0, 1.0], dtype=F32, device=nmap.device)
    normal = _cotangent_frame_normal(
        normal_geo, rec[..., 27:30], rec[..., 30:33], rec[..., 33:35], rec[..., 35:37], nmap
    )

    valid_f = valid[..., None].to(F32)
    ones = torch.ones((*hw, 1), dtype=F32, device=valid.device)

    def plane(rgb, alpha):
        return torch.cat([rgb, alpha], dim=-1) * valid_f

    return GBuffer(
        diffuse=plane(color_tex[..., :3], ones),
        specular=plane(color_tex[..., :3], ones),
        normal=plane(normal, torch.zeros_like(ones)),
        world_position=plane(position, ones),
        orm=plane(orm_tex[..., :3], ones),
    )
