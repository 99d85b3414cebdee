"""G-buffer resolve: visibility buffer -> shaded attribute planes.

Port of ``syzygy_tpu/kernels/resolve.py``. Single-mip geometry: per-
clipped-triangle attribute records are joined once per frame
(:func:`build_resolve_records`), then each pixel gathers its record through
the visibility buffer's slot id, interpolates perspective-correctly,
samples the plain texture atlas (bilinear, REPEAT inside each texture's
rect) and perturbs the normal with the analytic cotangent frame
(``offscreen.frag:25-59``). Mipmapped geometry
(``GeometryStatic.tex_rects_mips``) takes the multi-gather form
(:func:`_resolve_gbuffer_gathered`): the level of detail needs the
screen-space UV footprint, differenced against the neighbouring pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frame_bench.reference.device import constant
from frame_bench.reference.kernels.raster import TriSetup, VisibilityBuffer
from frame_bench.reference.math.geometry import matvec, matvec_fma, sqrt_rn, vec_norm
from frame_bench.reference.scene.pack import GeometryStatic

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


def sample_bilinear_repeat(tex_ids, textures, uv):
    """Bilinear + REPEAT sample from a texture array (N, S, S, 4)
    (``resolve.py:66-89``)."""
    size = textures.shape[1]
    p = uv * size - 0.5
    p0 = torch.floor(p)
    frac = p - p0
    i0 = torch.remainder(p0.to(torch.int64), size)
    i1 = torch.remainder(i0 + 1, size)
    x0, y0, x1, y1 = i0[..., 0], i0[..., 1], i1[..., 0], i1[..., 1]
    fx, fy = frac[..., 0:1], frac[..., 1:2]
    ids = tex_ids.long()
    top = textures[ids, y0, x0] * (1.0 - fx) + textures[ids, y0, x1] * fx
    bot = textures[ids, y1, x0] * (1.0 - fx) + textures[ids, y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def sample_atlas_repeat(tex_ids, atlas, rects, uv):
    """Bilinear + REPEAT sample of texture ``tex_ids`` from the atlas
    (``resolve.py:92-105``); REPEAT wraps inside the texture's own rect."""
    return sample_atlas_rect(rects[tex_ids.long()].long(), atlas, uv)


def sample_atlas_trilinear(tex_ids, atlas, rects_mips, uv, lod):
    """Trilinear atlas sample (``resolve.py:108-125``): two bilinear taps at
    the floor and ceil levels of ``lod`` (continuous, clamped to the
    pyramid), mixed by its fraction."""
    n_levels = rects_mips.shape[1]
    lod = torch.clamp(lod, 0.0, n_levels - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=n_levels - 1)
    fl = (lod - l0)[..., None]
    ids = tex_ids.long()
    a = sample_atlas_rect(rects_mips[ids, l0].long(), atlas, uv)
    b = sample_atlas_rect(rects_mips[ids, l1].long(), atlas, uv)
    return a * (1.0 - fl) + b * fl


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


def _record_rows(tris, tri_material, corner_bary, corner_w, geometry: GeometryStatic, world_positions, world_normals):
    """Records of the A and B slots of triangles ``tris`` (n, 3):
    ``corner_bary``/``corner_w`` hold their 2n slot rows, the n A slots
    first."""
    tris = tris.long()
    n_t = tris.shape[0]

    def tile2(x):
        return torch.cat([x, x], dim=0)

    p = tile2(world_positions[tris])  # (2n, 3, 3)
    n = tile2(world_normals[tris])
    u = tile2(geometry.uvs[tris])
    w3 = torch.cat([corner_bary, 1.0 - corner_bary[..., 0:1] - corner_bary[..., 1:2]], dim=-1)
    # clipped corners' attributes: c[t, k] = sum_j w3[t, k, j] * attr[t, j]
    cp = matvec_fma(p.transpose(1, 2)[:, None], w3)  # (2n, 3, 3)
    cn = matvec_fma(n.transpose(1, 2)[:, None], w3)
    cu = matvec_fma(u.transpose(1, 2)[:, None], w3)  # (2n, 3, 2)
    t2 = 2 * n_t
    rects = tile2(geometry.tex_rects[geometry.materials[tri_material.long()].long()])
    return torch.cat(
        [
            corner_w,
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


def build_resolve_records(setup: TriSetup, geometry: GeometryStatic, world_positions, world_normals):
    """Pre-joined per-slot attribute records, (T2pad, 49) f32
    (``resolve.py:303-460``).

    Layout: 0:3 corner w | 3:12 corner world pos | 12:21 corner normals |
    21:27 corner uvs | 27:30 dp1 | 30:33 dp2 | 33:35 duv1 | 35:37 duv2 |
    37:49 color/normal/orm atlas rects (small ints, exact in f32). Slot t
    and T+t share original triangle t; pad slots keep corner_w == 1 so
    background pixels (which gather some record) make no 0/0."""
    t2_pad = setup.orig_tri.shape[0]
    n_t = geometry.triangles.shape[0]
    rows = _record_rows(
        geometry.triangles, geometry.tri_material, setup.corner_bary[: 2 * n_t], setup.corner_w[: 2 * n_t],
        geometry, world_positions, world_normals,
    )
    pad = t2_pad - 2 * n_t
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

    normal = _cotangent_frame_normal(
        normal_geo, rec[..., 27:30], rec[..., 30:33], rec[..., 33:35], rec[..., 35:37],
        _decode_normal_map(normal_tex),
    )
    return _planes(valid, color_tex, normal, position, orm_tex)


def _decode_normal_map(normal_tex):
    """``offscreen.frag:50-55``: unsigned -> signed, green-up."""
    nmap = normal_tex[..., :3] * (255.0 / 127.0) - (128.0 / 127.0)
    return nmap * constant([1.0, -1.0, 1.0], F32, nmap.device)


def _planes(valid, color_tex, normal, position, orm_tex) -> GBuffer:
    valid_f = valid[..., None].to(F32)
    ones = torch.ones((*valid.shape, 1), dtype=F32, device=valid.device)

    def plane(rgb, alpha):
        return torch.cat([rgb, alpha], dim=-1) * valid_f

    return GBuffer(
        diffuse=plane(color_tex[..., :3], ones),
        specular=plane(color_tex[..., :3], ones),
        normal=plane(normal, torch.zeros_like(ones)),
        world_position=plane(position, ones),
        orm=plane(orm_tex[..., :3], ones),
    )


def resolve_gbuffer(vis: VisibilityBuffer, setup: TriSetup, geometry: GeometryStatic,
                    world_positions, world_normals) -> GBuffer:
    """Visibility buffer -> 5 G-buffer planes (``resolve.py:463-483``):
    the record form for single-mip geometry, the multi-gather form when the
    geometry carries a mip pyramid (level-dependent rect rows cannot be
    joined per triangle)."""
    if geometry.tex_rects_mips is not None:
        return _resolve_gbuffer_gathered(vis, setup, geometry, world_positions, world_normals)
    records = build_resolve_records(setup, geometry, world_positions, world_normals)
    return resolve_gbuffer_from_records(vis, records, geometry)


def _resolve_gbuffer_gathered(vis: VisibilityBuffer, setup: TriSetup, geometry: GeometryStatic,
                              world_positions, world_normals) -> GBuffer:
    """Multi-gather resolve (``resolve.py:571-682``): per pixel the
    original triangle's vertex attributes, interpolated with the weights
    mapped through the clip corners' barycentrics; with a mip pyramid the
    level of detail of each map from the UV footprint against the pixel to
    the left and above (0 at the frame's first row/column and where the
    neighbour is background or another triangle: the sharp level, as GPU
    quad derivatives choose at partial quads)."""
    valid = vis.tri >= 0
    tid = torch.clamp(vis.tri, min=0).long()
    orig = setup.orig_tri[tid].long()
    corner = setup.corner_bary[tid]  # (H, W, 3, 2)
    corner_w = setup.corner_w[tid]

    sb = torch.stack([vis.b0, vis.b1, 1.0 - vis.b0 - vis.b1], dim=-1)
    pc = sb / torch.clamp(corner_w, min=1e-8)
    pc = pc / torch.clamp(torch.sum(pc, dim=-1, keepdim=True), min=1e-20)
    ob01 = matvec_fma(corner.transpose(-1, -2), pc)  # (H, W, 2)
    pw = torch.cat([ob01, 1.0 - ob01[..., 0:1] - ob01[..., 1:2]], dim=-1)

    idx = geometry.triangles.long()[orig]  # (H, W, 3)

    def interp(attr):  # (V, C) -> (H, W, C)
        return matvec_fma(attr[idx].transpose(-1, -2), pw)

    position = interp(world_positions)
    normal_geo = interp(world_normals)
    normal_geo = normal_geo / _norm(normal_geo)
    uv = interp(geometry.uvs)

    mat = geometry.materials.long()[geometry.tri_material.long()[orig]]  # (H, W, 3)
    atlas = geometry.tex_atlas
    if geometry.tex_rects_mips is not None:
        same_x = (torch.roll(orig, 1, dims=1) == orig) & valid & torch.roll(valid, 1, dims=1)
        same_x[:, 0] = False  # the roll wraps: column 0 has no left neighbour
        same_y = (torch.roll(orig, 1, dims=0) == orig) & valid & torch.roll(valid, 1, dims=0)
        same_y[0, :] = False
        dudx = torch.where(same_x[..., None], torch.abs(uv - torch.roll(uv, 1, dims=1)), 0.0)
        dudy = torch.where(same_y[..., None], torch.abs(uv - torch.roll(uv, 1, dims=0)), 0.0)
        rect0 = geometry.tex_rects_mips[:, 0]

        def sample(ids):
            dims = rect0[ids][..., 2:4].to(F32)
            footprint = torch.maximum(
                torch.amax(dudx * dims, dim=-1), torch.amax(dudy * dims, dim=-1)
            )
            lod = torch.log2(torch.clamp(footprint, min=1.0))
            return sample_atlas_trilinear(ids, atlas, geometry.tex_rects_mips, uv, lod)
    else:
        def sample(ids):
            return sample_atlas_repeat(ids, atlas, geometry.tex_rects, uv)

    color_tex, normal_tex, orm_tex = sample(mat[..., 0]), sample(mat[..., 1]), sample(mat[..., 2])

    v0, v1, v2 = idx[..., 0], idx[..., 1], idx[..., 2]
    normal = _cotangent_frame_normal(
        normal_geo,
        world_positions[v1] - world_positions[v0],
        world_positions[v2] - world_positions[v0],
        geometry.uvs[v1] - geometry.uvs[v0],
        geometry.uvs[v2] - geometry.uvs[v0],
        _decode_normal_map(normal_tex),
    )
    return _planes(valid, color_tex, normal, position, orm_tex)
