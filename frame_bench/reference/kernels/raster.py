"""Plain software rasterizer: triangle setup and a block raster in torch.

A frozen copy of the port's triangle setup (``kernels/raster.py``:
near-plane clip fan, screen-space affine barycentric/depth forms with the
reference's fused multiply-adds, per-slot tile ranges) and of its plain
raster's per-pixel arithmetic. The raster here walks the target in
blocks of ``BLOCK_H x BLOCK_W`` pixels over every slot whose tile range
meets the block (full iteration, no tile lists), so a large shadow map
costs few steps. A slot is a candidate only on the tiles of its tile
range (a sliver's f32 test can pass far outside it), and per pixel the
largest candidate z wins, the larger slot on ties, committed where it
is ``>=`` the carried depth, so the result does not depend on the
blocking.

Conventions: screen x right / y down, pixel centers at +0.5, reverse-Z
(1 near, 0 far), front faces CW on screen (positive doubled area).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frame_bench.reference.device import constant
from frame_bench.reference.math.geometry import fma32

TILE_H = 64
TILE_W = 128
CHUNK = 64  # slot-count padding multiple (keeps slot ids equal to the reference's)
TILE_LIST_CAPACITY = 448  # RenderConfig.tile_list_capacity's default, in CHUNKs of slots
W_CLIP_EPS = 1e-3  # near-plane clip guard in view-z units (w_clip = z_view)
_TILE_PACK = 4096.0
_COEFF_WIDTH = 12
_PLAIN_BATCH = 512  # triangles per vectorized step of rasterize_plain

F32 = torch.float32


class TriSetup(NamedTuple):
    """Screen-space triangle records after near-clip (2T slots, padded to a
    CHUNK multiple)."""

    # (T2pad, 12) f32: 0:alpha0 1:beta0 2:gamma0 | 3:alpha1 4:beta1
    # 5:gamma1 | 6:z2 7:dz0 8:dz1 | 9:valid | 10: tx0*4096 + tx1+1 |
    # 11: ty0*4096 + ty1+1 (the slot's 64x128 tile range, exact in f32)
    coeffs: torch.Tensor
    orig_tri: torch.Tensor  # (T2pad,) i32 -> original triangle id
    corner_bary: torch.Tensor  # (T2pad, 3, 2) corners' (b0, b1) wrt the original
    corner_w: torch.Tensor  # (T2pad, 3) clip w of the (possibly clipped) corners


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor  # (H, W) f32, reverse-Z, 0 = background
    tri: torch.Tensor  # (H, W) i32 slot id, -1 = background (empty if depth-only)
    b0: torch.Tensor  # (H, W) f32 screen-space barycentric
    b1: torch.Tensor  # (H, W) f32


# ---------------------------------------------------------------------------
# triangle setup
# ---------------------------------------------------------------------------


# The reference's setup and raster run under XLA CPU jit, where LLVM
# contracts some ``a * b + c`` into fused multiply-adds; the port puts fmas
# at the same places so coefficient rows and plane evaluations match
# bitwise, which keeps knife-edge pixels (edges through pixel centers) on
# the same side.
_fma = fma32


def _rotate_corners(arr: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate the corner axis (axis 1, size 3) by a per-row amount."""
    r1 = torch.cat([arr[:, 1:], arr[:, :1]], dim=1)
    r2 = torch.cat([arr[:, 2:], arr[:, :2]], dim=1)
    expand = (slice(None),) + (None,) * (arr.ndim - 1)
    return torch.where((rot == 1)[expand], r1, torch.where((rot == 2)[expand], r2, arr))


def _setup_slots(tri_corner_clip, tri_valid, width, height, cull_keep_sign,
                 depth_bias_constant=0.0, depth_bias_slope=0.0):
    """Per-slot screen records (``raster.py:101-244``): clip fan, projection,
    affine forms, screen bboxes. Returns (cols (2T, 14), bary (2T, 3, 2),
    w (2T, 3))."""
    dev = tri_corner_clip.device
    w = tri_corner_clip[..., 3]
    inside = w >= W_CLIP_EPS
    n_in = inside.sum(dim=-1)
    inside_i = inside.to(torch.int32)
    rot_one = torch.argmax(inside_i, dim=-1)
    rot_two = torch.argmin(inside_i, dim=-1)
    rot = torch.where(n_in == 1, rot_one, torch.where(n_in == 2, rot_two, 0))

    v = _rotate_corners(tri_corner_clip, rot)
    eye_bary = constant([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], F32, dev)
    vb = _rotate_corners(eye_bary[None].expand(rot.shape[0], 3, 2), rot)

    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    b0c, b1c, b2c = vb[:, 0], vb[:, 1], vb[:, 2]

    def lerp_to_plane(pa, pb, ba, bb):
        den = pb[..., 3] - pa[..., 3]
        t = (W_CLIP_EPS - pa[..., 3]) / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
        t = torch.clamp(t, 0.0, 1.0)[..., None]
        return _fma(t, pb - pa, pa), _fma(t[..., 0:1], bb - ba, ba)

    i01, b01 = lerp_to_plane(v0, v1, b0c, b1c)
    i02, b02 = lerp_to_plane(v0, v2, b0c, b2c)
    i20, b20 = lerp_to_plane(v2, v0, b2c, b0c)

    def case_select(three, one, two):
        return torch.where(
            (n_in == 3)[:, None, None], three,
            torch.where((n_in == 1)[:, None, None], one, two),
        )

    tri_a = case_select(
        torch.stack([v0, v1, v2], 1), torch.stack([v0, i01, i02], 1), torch.stack([i01, v1, v2], 1)
    )
    bary_a = case_select(
        torch.stack([b0c, b1c, b2c], 1), torch.stack([b0c, b01, b02], 1), torch.stack([b01, b1c, b2c], 1)
    )
    tri_b = torch.stack([i01, v2, i20], 1)
    bary_b = torch.stack([b01, b2c, b20], 1)

    all_tris = torch.cat([tri_a, tri_b], dim=0)
    all_bary = torch.cat([bary_a, bary_b], dim=0)
    all_valid = torch.cat([tri_valid & (n_in > 0), tri_valid & (n_in == 2)], dim=0)

    w_all = torch.clamp(all_tris[..., 3], min=W_CLIP_EPS * 0.5)
    ndc = all_tris[..., :3] / w_all[..., None]
    ux = ndc[..., 0] * 0.5 + 0.5  # x * 0.5 is exact: no contraction to mimic
    uy = ndc[..., 1] * 0.5 + 0.5
    sx = ux * width
    sy = uy * height
    sz = ndc[..., 2]

    x0, x1, x2 = sx[:, 0], sx[:, 1], sx[:, 2]
    y0, y1, y2 = sy[:, 0], sy[:, 1], sy[:, 2]
    # The reference's compiled area recomputes the screen positions and
    # contracts each single-use product (corners 1 and 2) into its
    # subtraction from corner 0; exact when the viewport side is a power
    # of two, one rounding fewer otherwise.
    w_t = torch.full((), float(width), dtype=F32, device=dev)
    h_t = torch.full((), float(height), dtype=F32, device=dev)
    dx10, dx20 = _fma(ux[:, 1], w_t, -x0), _fma(ux[:, 2], w_t, -x0)
    dy10, dy20 = _fma(uy[:, 1], h_t, -y0), _fma(uy[:, 2], h_t, -y0)
    area2 = _fma(dx10, dy20, -(dy10 * dx20))
    if cull_keep_sign > 0:
        facing = area2 > 0
    elif cull_keep_sign < 0:
        facing = area2 < 0
    else:
        facing = torch.abs(area2) > 0
    all_valid = all_valid & facing & (torch.abs(area2) > 1e-12)

    inv = torch.where(torch.abs(area2) < 1e-12, 0.0, 1.0 / area2)
    beta0 = -(y2 - y1) * inv
    gamma0 = (x2 - x1) * inv
    alpha0 = _fma(y2 - y1, x1, -((x2 - x1) * y1)) * inv
    beta1 = -(y0 - y2) * inv
    gamma1 = (x0 - x2) * inv
    alpha1 = _fma(y0 - y2, x2, -((x0 - x2) * y2)) * inv
    z2c = sz[:, 2]
    dz0 = sz[:, 0] - sz[:, 2]
    dz1 = sz[:, 1] - sz[:, 2]
    if depth_bias_constant != 0.0 or depth_bias_slope != 0.0:
        # vkCmdSetDepthBias: constant * 2^-23 + slope * max|dz/dxy|, folded
        # into the affine depth (constant per triangle)
        slope_m = torch.maximum(
            torch.abs(dz0 * beta0 + dz1 * beta1), torch.abs(dz0 * gamma0 + dz1 * gamma1)
        )
        z2c = z2c + (depth_bias_constant * 2.0**-23 + depth_bias_slope * slope_m)

    inf = torch.full((), float("inf"), dtype=F32, device=dev)
    cols = torch.stack(
        [
            alpha0, beta0, gamma0, alpha1, beta1, gamma1, z2c, dz0, dz1,
            all_valid.to(F32),
            torch.where(all_valid, torch.amin(sx, dim=1), inf),
            torch.where(all_valid, torch.amax(sx, dim=1), -inf),
            torch.where(all_valid, torch.amin(sy, dim=1), inf),
            torch.where(all_valid, torch.amax(sy, dim=1), -inf),
        ],
        dim=-1,
    )
    return cols, all_bary, w_all


def _finish_setup(cols, all_bary, w_all, grid_width, grid_height, grid_origin) -> TriSetup:
    """Tile ranges for this grid + padding to the CHUNK multiple
    (``raster.py:247-360``). The affine forms stay in GLOBAL pixel
    coordinates; only the tile ranges depend on the origin."""
    dev = cols.device
    bb_min_x, bb_max_x, bb_min_y, bb_max_y = cols[:, 10], cols[:, 11], cols[:, 12], cols[:, 13]
    oy = float(grid_origin[0])
    ox = float(grid_origin[1])
    t2 = cols.shape[0]
    t2_pad = -(-t2 // CHUNK) * CHUNK
    n_t = t2 // 2
    tiles_y = -(-grid_height // TILE_H)
    tiles_x = -(-grid_width // TILE_W)

    def tile_range(lo, hi, origin, tile, n):
        t0 = torch.clamp(torch.floor((lo - origin) / tile), 0, n).to(torch.int32)
        t1 = torch.clamp(torch.floor((hi - origin) / tile), -1, n - 1).to(torch.int32)
        return t0.to(F32) * _TILE_PACK + (t1 + 1).to(F32)

    packx = tile_range(bb_min_x, bb_max_x, ox, TILE_W, tiles_x)
    packy = tile_range(bb_min_y, bb_max_y, oy, TILE_H, tiles_y)
    coeffs = torch.cat([cols[:, :10], packx[:, None], packy[:, None]], dim=-1)
    pad = t2_pad - t2
    ar = torch.arange(n_t, dtype=torch.int32, device=dev)
    coeffs = torch.cat([coeffs, torch.zeros((pad, _COEFF_WIDTH), dtype=F32, device=dev)])
    return TriSetup(
        coeffs=coeffs,
        orig_tri=torch.cat([ar, ar, torch.zeros(pad, dtype=torch.int32, device=dev)]),
        corner_bary=torch.cat([all_bary, torch.zeros((pad, 3, 2), dtype=F32, device=dev)]),
        corner_w=torch.cat([w_all, torch.ones((pad, 3), dtype=F32, device=dev)]),
    )


def setup_triangles(
    clip,  # (V, 4) clip-space positions (ignored when corner_clip is given)
    triangles: torch.Tensor,  # (T, 3) i32
    tri_valid: torch.Tensor,  # (T,) bool
    width: int,
    height: int,
    cull_keep_sign: int,  # +1 keep CW/front (camera), -1 keep CCW (shadow), 0 none
    grid_width: int | None = None,
    grid_height: int | None = None,
    grid_origin=(0, 0),  # global (y, x) pixel origin of the raster target
    corner_clip: torch.Tensor | None = None,  # (T, 3, 4) pre-gathered corners
    depth_bias_constant: float = 0.0,
    depth_bias_slope: float = 0.0,
) -> TriSetup:
    """Vectorized triangle setup with near-plane clipping
    (``raster.py:363-479``). ``width``/``height`` are the viewport,
    ``grid_*`` the padded raster target (default: rounded up to tiles)."""
    grid_width = -(-width // TILE_W) * TILE_W if grid_width is None else grid_width
    grid_height = -(-height // TILE_H) * TILE_H if grid_height is None else grid_height
    corners = clip[triangles.long()] if corner_clip is None else corner_clip
    cols, all_bary, w_all = _setup_slots(
        corners, tri_valid, width, height, cull_keep_sign, depth_bias_constant, depth_bias_slope,
    )
    return _finish_setup(cols, all_bary, w_all, grid_width, grid_height, grid_origin)


# ---------------------------------------------------------------------------
# the raster
# ---------------------------------------------------------------------------

BLOCK_H = 4 * TILE_H
BLOCK_W = 4 * TILE_W
_STEP_ELEMENTS = 1 << 23  # slot x pixel evaluations per vectorized step


def tile_ranges(coeffs: torch.Tensor):
    """Each slot's tile range from coefficient columns 10/11, int64:
    (tx0, tx1 + 1, ty0, ty1 + 1); empty for invalid slots."""
    pkx = coeffs[:, 10].to(torch.int64)
    pky = coeffs[:, 11].to(torch.int64)
    return pkx // 4096, pkx % 4096, pky // 4096, pky % 4096


def rasterize(
    setup: TriSetup, width: int, height: int, depth_only: bool = False,
    origin=(0, 0), capacity: int = 0,
) -> VisibilityBuffer:
    """Visibility (or depth-only) raster of a padded ``height x width``
    target (tile multiples), in plain torch (module docstring).
    ``capacity`` is the program's tile-list size and changes nothing
    here."""
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"raster target {width}x{height} is not a tile multiple")
    dev = setup.coeffs.device
    tx0, tx1p, ty0, ty1p = tile_ranges(setup.coeffs)
    oy, ox = int(origin[0]), int(origin[1])
    depth = torch.zeros((height, width), dtype=F32, device=dev)
    tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    b0 = torch.zeros((height, width), dtype=F32, device=dev)
    b1 = torch.zeros((height, width), dtype=F32, device=dev)
    for y0 in range(0, height, BLOCK_H):
        y1 = min(y0 + BLOCK_H, height)
        for x0 in range(0, width, BLOCK_W):
            x1 = min(x0 + BLOCK_W, width)
            touches = (
                (tx0 < x1 // TILE_W) & (tx1p > x0 // TILE_W) & (ty0 < y1 // TILE_H) & (ty1p > y0 // TILE_H)
            )
            block_slots = torch.nonzero(touches).flatten()
            if block_slots.numel() == 0:
                continue
            xs = torch.arange(x0, x1, device=dev)
            ys = torch.arange(y0, y1, device=dev)
            px = ((xs + ox).to(F32) + 0.5)[None, None, :]
            py = ((ys + oy).to(F32) + 0.5)[None, :, None]
            col_tile = (xs // TILE_W)[None, None, :]
            row_tile = (ys // TILE_H)[None, :, None]
            d, t, e0_t, e1_t = (a[y0:y1, x0:x1] for a in (depth, tri, b0, b1))
            batch = max(1, _STEP_ELEMENTS // ((y1 - y0) * (x1 - x0)))
            for s in range(0, block_slots.numel(), batch):
                ids = block_slots[s : s + batch]
                c = setup.coeffs[ids][:, :, None, None]  # (B, 12, 1, 1)
                e0 = _fma(c[:, 1], px, c[:, 0]) + c[:, 2] * py
                e1 = _fma(c[:, 4], px, c[:, 3]) + c[:, 5] * py
                e2 = (1.0 - e0) - e1
                z = _fma(c[:, 8], e1, _fma(c[:, 7], e0, c[:, 6]))
                in_range = (
                    (tx0[ids][:, None, None] <= col_tile) & (col_tile < tx1p[ids][:, None, None])
                    & (ty0[ids][:, None, None] <= row_tile) & (row_tile < ty1p[ids][:, None, None])
                )
                cand = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z <= 1.0) & (z >= 0.0) & (c[:, 9] > 0) & in_range
                zm = torch.where(cand, z, -1.0)
                best = zm.amax(dim=0)
                order = torch.arange(ids.shape[0], device=dev)[:, None, None]
                win = torch.where(zm == best, order, -1).amax(dim=0)  # last index on ties
                hit = best >= d
                d.copy_(torch.where(hit, best, d))
                if not depth_only:
                    t.copy_(torch.where(hit, ids[win].to(torch.int32), t))
                    e0_t.copy_(torch.where(hit, e0.gather(0, win[None])[0], e0_t))
                    e1_t.copy_(torch.where(hit, e1.gather(0, win[None])[0], e1_t))
    if depth_only:
        empty = torch.zeros((0, 0), dtype=F32, device=dev)
        return VisibilityBuffer(depth, empty, empty, empty)
    return VisibilityBuffer(depth, tri, b0, b1)
