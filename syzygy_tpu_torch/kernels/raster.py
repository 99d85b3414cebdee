"""Tile-binned software rasterizer: triangle setup, exact binning, raster.

Port of ``syzygy_tpu/kernels/raster.py``. Three parts:

1. :func:`setup_triangles` (torch, vectorized): clip-space corners ->
   near-plane clip fan (each triangle may split in two: slots t and T+t),
   screen-space affine barycentric/depth forms and per-slot tile ranges.
   Same arithmetic as the reference's jitted setup (including its fused
   multiply-adds), so the coefficient rows agree bitwise.
2. :func:`bin_triangles` (torch, on the device, static sizes): per-tile
   slot lists, ascending slot order within each tile, built from the tile
   ranges in coefficient columns 10/11 by a count / scan / sort into a
   pair budget sized from ``tile_list_capacity``. Lists that would drop a
   slot set a device flag, and the raster then takes full iteration (the
   reference's ``lax.cond`` to its iterate-all-chunks kernel,
   ``frame.py:64-141``); nothing is read back to the host.
3. :func:`rasterize`: the visibility (or depth-only) raster over the
   lists (K1/K2), or over every slot (full iteration, K3/K4: at
   ``capacity=0`` or when the lists overflowed). On a CUDA tensor it
   launches the hand-written kernel ``csrc/raster.cu``; on a CPU tensor
   it runs :func:`rasterize_plain`, the same function in torch.

Conventions: screen x right / y down, pixel centers at +0.5, reverse-Z
(1 near, 0 far), a depth test of ``z >= depth`` in ascending slot order (the
later slot wins a tie), front faces CW on screen (positive doubled area).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from syzygy_tpu_torch.device import constant
from syzygy_tpu_torch.kernels import build
from syzygy_tpu_torch.math.geometry import fma32

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
    # (T2pad, 4) i32 [x0, x1, y0, y1]: the inclusive target-local pixel range
    # outside which the slot's f32 hit test cannot pass (:func:`pixel_boxes`;
    # port-side, the reference has no counterpart)
    pixel_box: torch.Tensor


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor  # (H, W) f32, reverse-Z, 0 = background
    tri: torch.Tensor  # (H, W) i32 slot id, -1 = background (empty if depth-only)
    b0: torch.Tensor  # (H, W) f32 screen-space barycentric
    b1: torch.Tensor  # (H, W) f32


class TileLists(NamedTuple):
    """Per-tile slot lists: tile i owns ``slots[offsets[i]:offsets[i+1]]``
    in ascending slot order; entries past ``offsets[-1]`` are padding.
    ``overflow`` (a () bool tensor on the lists' device) is set when the
    lists dropped a slot: a raster over them must then take full
    iteration."""

    slots: torch.Tensor  # (P,) i32, P static
    offsets: torch.Tensor  # (tiles + 1,) i32
    tiles_y: int
    tiles_x: int
    overflow: torch.Tensor


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
        pixel_box=pixel_boxes(coeffs, grid_width, grid_height, grid_origin),
    )


_U32 = 2.0**-24  # unit roundoff of f32
_U64 = 2.0**-53  # unit roundoff of f64


def pixel_boxes(coeffs: torch.Tensor, grid_width: int, grid_height: int, grid_origin=(0, 0)) -> torch.Tensor:
    """Per slot, the inclusive target-local pixel box ``[x0, x1, y0, y1]``
    (int32, (T2pad, 4)) outside which the raster's f32 hit test of the
    slot cannot pass at any pixel centre of the target.

    The kernel evaluates ``e0 = fl(fl(fma(be0, px, a0)) + fl(g0 * py))``
    (and ``e1`` alike), ``e2 = fl(fl(1 - e0) - e1)``, and needs every
    ``e_i >= 0``. With ``E_i`` the same forms in exact arithmetic over the
    f32 coefficients (``E2 = 1 - E0 - E1``) and ``B_k = |a_k| + |be_k| X +
    |g_k| Y`` (``X``, ``Y`` the largest global pixel coordinates of the
    target), standard error analysis gives ``|e_k - E_k| <= (2u + u^2) B_k``
    and ``|e2 - E2| <= |e0 - E0| + |e1 - E1| + u (2 + 2.1 B0 + 1.1 B1)``
    (u = 2^-24), so a hit needs ``E_i >= -eps_i`` with ``eps_k = 3u B_k``
    (+ 1e-30 for subnormal products) and ``eps_2 = eps_0 + eps_1 +
    3u (1 + B0 + B1)``. That region is the triangle whose corners solve
    two of the three equalities; their float64 solutions carry a bound of
    their own rounding (``32 * 2^-53`` of the magnitudes summed, far above
    the few roundings made, + 1e-6 px), added to the box.

    Slivers (|area2| near 1e-12, coefficients up to ~1e12) get enormous
    error terms, and a slot whose determinant is 0 or whose corners are
    not finite gets the whole target: the box then covers every pixel of
    the slot's listed tiles, which is the whole-tile evaluation the
    reference runs. Invalid slots get an empty box (``x0 > x1``)."""
    dev = coeffs.device
    c = coeffs[:, :6].double()
    a0, be0, g0, a1, be1, g1 = c.unbind(1)
    oy, ox = float(grid_origin[0]), float(grid_origin[1])
    x_max = max(abs(ox), abs(ox + grid_width))
    y_max = max(abs(oy), abs(oy + grid_height))
    bound0 = a0.abs() + be0.abs() * x_max + g0.abs() * y_max
    bound1 = a1.abs() + be1.abs() * x_max + g1.abs() * y_max
    eps0 = 3 * _U32 * bound0 + 1e-30
    eps1 = 3 * _U32 * bound1 + 1e-30
    eps2 = eps0 + eps1 + 3 * _U32 * (1 + bound0 + bound1)
    # the corners: (E0, E1) = (-eps0, -eps1), (-eps0, 1+eps0+eps2), (1+eps1+eps2, -eps1)
    t0 = torch.stack([-eps0, -eps0, 1 + eps1 + eps2])
    t1 = torch.stack([-eps1, 1 + eps0 + eps2, -eps1])
    det = be0 * g1 - g0 * be1  # f32 products are exact in f64
    r0, r1 = t0 - a0, t1 - a1
    x = (r0 * g1 - g0 * r1) / det
    y = (be0 * r1 - be1 * r0) / det
    m0, m1 = t0.abs() + a0.abs(), t1.abs() + a1.abs()
    # + 1e-6 px covers the roundings of the pixel-centre shifts below
    err_x = 32 * _U64 * (m0 * g1.abs() + g0.abs() * m1) / det.abs() + 1e-6
    err_y = 32 * _U64 * (be0.abs() * m1 + be1.abs() * m0) / det.abs() + 1e-6
    x_lo, x_hi = (x - err_x).amin(0), (x + err_x).amax(0)
    y_lo, y_hi = (y - err_y).amin(0), (y + err_y).amax(0)
    conditioned = (det != 0) & torch.isfinite(torch.stack([x_lo, x_hi, y_lo, y_hi])).all(0)
    w, h = float(grid_width), float(grid_height)
    # pixel (target-local) gx is tested at centre gx + ox + 0.5
    bx0 = torch.where(conditioned, torch.ceil(x_lo - 0.5 - ox).clamp(0, w), 0.0)
    bx1 = torch.where(conditioned, torch.floor(x_hi - 0.5 - ox).clamp(-1, w - 1), w - 1)
    by0 = torch.where(conditioned, torch.ceil(y_lo - 0.5 - oy).clamp(0, h), 0.0)
    by1 = torch.where(conditioned, torch.floor(y_hi - 0.5 - oy).clamp(-1, h - 1), h - 1)
    box = torch.stack([bx0, bx1, by0, by1], dim=1).to(torch.int32)
    empty = constant([1, 0, 1, 0], torch.int32, dev)
    return torch.where((coeffs[:, 9] > 0)[:, None], box, empty).contiguous()


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
    group=None,
) -> TriSetup:
    """Vectorized triangle setup with near-plane clipping
    (``raster.py:363-479``). ``width``/``height`` are the viewport,
    ``grid_*`` the padded raster target (default: rounded up to tiles).

    ``group`` (a ``parallel.sharding.Group``, the reference's
    ``shard_axis``): when it has several ranks and their count divides T,
    each rank computes the slot records of a contiguous T / size triangle
    slice and ``all_gather`` rejoins them in the slot order of the
    unsharded setup (the raster's depth ties depend on it), bitwise the
    unsharded result; the grid-dependent tile ranges stay per rank.
    Otherwise every rank runs the whole setup."""
    grid_width = -(-width // TILE_W) * TILE_W if grid_width is None else grid_width
    grid_height = -(-height // TILE_H) * TILE_H if grid_height is None else grid_height
    lo, loc, split = triangle_share(group, tri_valid.shape[0])
    part = slice(lo, lo + loc)
    corners = clip[triangles[part].long()] if corner_clip is None else corner_clip[part]
    local = _setup_slots(
        corners, tri_valid[part], width, height, cull_keep_sign,
        depth_bias_constant, depth_bias_slope,
    )
    cols, all_bary, w_all = (rejoin_slots(group.all_gather(x)) for x in local) if split else local
    return _finish_setup(cols, all_bary, w_all, grid_width, grid_height, grid_origin)


def triangle_share(group, n_t: int) -> tuple[int, int, bool]:
    """(first, count, split): this rank's contiguous slice of ``n_t``
    triangles under ``group``, and whether the work is split at all (a
    group of several ranks whose count divides ``n_t``; else the whole
    range, (0, n_t), on every rank)."""
    if group is None or group.size == 1 or n_t % group.size:
        return 0, n_t, False
    loc = n_t // group.size
    return group.index * loc, loc, True


def rejoin_slots(gathered: torch.Tensor) -> torch.Tensor:
    """Per-rank slot rows of contiguous triangle slices, (ranks, 2 * loc,
    ...) with each rank's A slots before its B slots, -> the canonical
    (2T, ...) layout: every A slot in triangle order, then every B slot."""
    loc = gathered.shape[1] // 2
    tail = gathered.shape[2:]
    return torch.cat([gathered[:, :loc].reshape(-1, *tail), gathered[:, loc:].reshape(-1, *tail)])


# ---------------------------------------------------------------------------
# binning with static sizes
# ---------------------------------------------------------------------------


def pair_budget(n_slots: int, n_tiles: int, capacity: int) -> int:
    """The (tile, slot) pairs :func:`bin_triangles` has room for: one tile
    per slot plus ``CHUNK`` whole-target slots, and never more than
    ``n_tiles`` lists of ``capacity * CHUNK`` slots each (the reference's
    per-tile capacity is ``capacity`` chunks of ``CHUNK`` slots)."""
    return max(1, min(n_tiles * min(capacity * CHUNK, n_slots), n_slots + CHUNK * n_tiles))


def tile_ranges(coeffs: torch.Tensor):
    """Each slot's tile range from coefficient columns 10/11, int64:
    (tx0, tx1 + 1, ty0, ty1 + 1); empty for invalid slots."""
    pkx = coeffs[:, 10].to(torch.int64)
    pky = coeffs[:, 11].to(torch.int64)
    return pkx // 4096, pkx % 4096, pky // 4096, pky % 4096


def bin_triangles(coeffs: torch.Tensor, height: int, width: int, capacity: int = TILE_LIST_CAPACITY) -> TileLists:
    """Per-tile slot lists from coefficient columns 10/11, on the
    coefficients' device, every size static: no host sync.

    Count the tiles each slot touches, scan, map each of
    :func:`pair_budget`'s pair indices to its slot by a binary search of
    the scan, sort the pairs by tile (stable: slots ascending within a
    tile) and find the per-tile offsets by a binary search of the sorted
    tiles. ``overflow`` is set when the pairs exceed the budget or a tile
    lists more than ``capacity * CHUNK`` slots: the lists then lack a slot
    and the raster takes full iteration (the reference's rule,
    ``frame.py:64-141``). ``capacity`` >= 1; 0 (no lists, full iteration)
    is :func:`rasterize`'s."""
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"raster target {width}x{height} is not a tile multiple")
    if capacity < 1:
        raise ValueError(f"tile list capacity {capacity}: lists need at least 1")
    dev = coeffs.device
    tiles_y, tiles_x = height // TILE_H, width // TILE_W
    n_tiles = tiles_y * tiles_x
    n_slots = coeffs.shape[0]
    budget = pair_budget(n_slots, n_tiles, capacity)
    if n_slots == 0:
        return TileLists(
            torch.zeros(budget, dtype=torch.int32, device=dev),
            torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev),
            tiles_y, tiles_x, torch.zeros((), dtype=torch.bool, device=dev),
        )
    tx0, tx1p, ty0, ty1p = tile_ranges(coeffs)
    nx = torch.clamp(tx1p - tx0, min=0)
    ny = torch.clamp(ty1p - ty0, min=0)
    count = nx * ny
    end = torch.cumsum(count, 0)  # pairs of slots [0, s]
    pair = torch.arange(budget, device=dev)
    slot = torch.searchsorted(end, pair, right=True).clamp_(max=n_slots - 1)
    local = pair - (end - count)[slot]  # the pair's rank among its slot's tiles
    nx_s = nx[slot].clamp(min=1)
    tile = (ty0[slot] + local // nx_s) * tiles_x + (tx0[slot] + local % nx_s)
    total = end[-1]
    tile = torch.where(pair < total, tile, n_tiles).to(torch.int32)  # padding sorts last
    tile, order = torch.sort(tile, stable=True)
    offsets = torch.searchsorted(tile, torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)).to(torch.int32)
    longest = (offsets[1:] - offsets[:-1]).amax()
    overflow = (total > budget) | (longest > capacity * CHUNK)
    return TileLists(slot[order].to(torch.int32), offsets, tiles_y, tiles_x, overflow)


# ---------------------------------------------------------------------------
# the raster: plain torch version and the CUDA kernel wrapper
# ---------------------------------------------------------------------------


def rasterize_plain(
    setup: TriSetup, width: int, height: int, depth_only: bool = False,
    origin=(0, 0), lists: TileLists | None = None, full: bool = False,
) -> VisibilityBuffer:
    """The raster in plain torch, per tile over batches of its slots.

    A tile's slots are its list (``lists``, or :func:`bin_triangles` at
    the default capacity), or with ``full`` (or lists that overflowed)
    every slot whose tile range holds the tile: the full-iteration raster,
    the same slots per tile. Each batch evaluates every slot's affine
    forms over the whole tile with the kernel's operations (``b0 =
    fma(be0, px, a0) + g0 * py``, ``z = fma(dz1, b1, fma(dz0, b0,
    z2))``: the fused multiply-adds of the reference's CPU vector raster),
    picks per pixel the maximal candidate z (the LARGER slot on ties) and
    commits it where it is ``>=`` the carried depth: the
    ``_chunk_loop_vector`` formulation
    (``syzygy_tpu/kernels/raster.py:644-664``), equal to the serial
    ascending-slot ``z >= depth`` loop the CUDA kernel runs. A plain
    stand-in reads its lists on the host."""
    dev = setup.coeffs.device
    if not full and lists is None:
        lists = bin_triangles(setup.coeffs, height, width)
    full = full or bool(lists.overflow)
    tiles_y, tiles_x = height // TILE_H, width // TILE_W
    if full:
        tx0, tx1p, ty0, ty1p = tile_ranges(setup.coeffs)
    else:
        offsets = lists.offsets.tolist()
    oy, ox = int(origin[0]), int(origin[1])
    depth = torch.zeros((height, width), dtype=F32, device=dev)
    tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    b0 = torch.zeros((height, width), dtype=F32, device=dev)
    b1 = torch.zeros((height, width), dtype=F32, device=dev)
    rows = torch.arange(TILE_H, device=dev)
    cols = torch.arange(TILE_W, device=dev)
    for tile in range(tiles_y * tiles_x):
        ty, tx = divmod(tile, tiles_x)
        if full:
            touches = (tx0 <= tx) & (tx < tx1p) & (ty0 <= ty) & (ty < ty1p)
            tile_slots = torch.nonzero(touches).flatten()
        else:
            tile_slots = lists.slots[offsets[tile] : offsets[tile + 1]]
        if tile_slots.numel() == 0:
            continue
        ys = slice(ty * TILE_H, (ty + 1) * TILE_H)
        xs = slice(tx * TILE_W, (tx + 1) * TILE_W)
        px = ((tx * TILE_W + ox + cols).to(F32) + 0.5)[None, None, :]
        py = ((ty * TILE_H + oy + rows).to(F32) + 0.5)[None, :, None]
        d, t, e0_t, e1_t = depth[ys, xs], tri[ys, xs], b0[ys, xs], b1[ys, xs]
        for s in range(0, tile_slots.numel(), _PLAIN_BATCH):
            ids = tile_slots[s : s + _PLAIN_BATCH].long()
            c = setup.coeffs[ids][:, :, None, None]  # (B, 12, 1, 1)
            e0 = _fma(c[:, 1], px, c[:, 0]) + c[:, 2] * py
            e1 = _fma(c[:, 4], px, c[:, 3]) + c[:, 5] * py
            e2 = (1.0 - e0) - e1
            z = _fma(c[:, 8], e1, _fma(c[:, 7], e0, c[:, 6]))
            cand = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z <= 1.0) & (z >= 0.0) & (c[:, 9] > 0)
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


def _launch_kernel(setup: TriSetup, lists: TileLists | None, height, width, depth_only, origin):
    """Launch ``csrc/raster.cu`` over ``lists``, or by full iteration when
    they are None."""
    coeffs = setup.coeffs
    if coeffs.dtype != F32 or not coeffs.is_contiguous() or coeffs.shape[1] != _COEFF_WIDTH:
        raise ValueError("coeffs must be a contiguous (T2pad, 12) float32 tensor")
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"raster target {width}x{height} is not a tile multiple")
    tiles_y, tiles_x = height // TILE_H, width // TILE_W
    box = setup.pixel_box
    if box.dtype != torch.int32 or not box.is_contiguous() or tuple(box.shape) != (coeffs.shape[0], 4):
        raise ValueError("pixel_box must be a contiguous (T2pad, 4) int32 tensor")
    if box.data_ptr() % 16:
        raise ValueError("pixel_box must start on a 16-byte boundary (the kernel reads int4 rows)")
    dev = coeffs.device
    slots = offsets = overflow = None
    if lists is not None:
        if lists.slots.dtype != torch.int32 or lists.offsets.dtype != torch.int32:
            raise ValueError("tile lists must be int32")
        if (lists.tiles_y, lists.tiles_x) != (tiles_y, tiles_x):
            raise ValueError(f"tile lists cover {lists.tiles_x}x{lists.tiles_y} tiles, not {width}x{height} px")
        slots, offsets, overflow = lists.slots, lists.offsets, lists.overflow
        if overflow.dtype != torch.bool or overflow.numel() != 1:
            raise ValueError("the overflow flag must be one bool")
        if any(t.device != dev for t in (slots, offsets, overflow)):
            raise ValueError("tile lists, pixel boxes and coefficients must be on one device")
        if slots.numel() == 0:
            slots = torch.zeros(1, dtype=torch.int32, device=dev)
    if box.device != dev:
        raise ValueError("pixel boxes and coefficients must be on one device")
    depth = torch.empty((height, width), dtype=F32, device=dev)
    if depth_only:
        tri = b0 = b1 = None
    else:
        tri = torch.empty((height, width), dtype=torch.int32, device=dev)
        b0 = torch.empty((height, width), dtype=F32, device=dev)
        b1 = torch.empty((height, width), dtype=F32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    # a listed launch whose lists overflowed takes full iteration inside
    # the kernel and counts as listed
    kind = ("depth" if depth_only else "visibility") + ("_full" if lists is None else "")
    build.launch(
        "szg_raster", dev,
        coeffs.data_ptr(), box.data_ptr(), coeffs.shape[0], ptr(slots), ptr(offsets), ptr(overflow),
        int(lists is None), tiles_y, tiles_x, int(origin[0]), int(origin[1]), int(depth_only),
        depth.data_ptr(), ptr(tri), ptr(b0), ptr(b1), counts={kind: 1},
    )
    if depth_only:
        empty = torch.zeros((0, 0), dtype=F32, device=dev)
        return VisibilityBuffer(depth, empty, empty, empty)
    return VisibilityBuffer(depth, tri, b0, b1)


def rasterize(
    setup: TriSetup, width: int, height: int, depth_only: bool = False,
    origin=(0, 0), lists: TileLists | None = None, capacity: int = TILE_LIST_CAPACITY,
) -> VisibilityBuffer:
    """Visibility (or depth-only) raster of a padded ``height x width``
    target (tile multiples). One function replaces the reference's four
    ``pallas_call`` sites: over per-tile lists (K1/K2: ``lists``, or
    :func:`bin_triangles` at ``capacity``; lists that overflowed make the
    kernel take full iteration, decided on the device), or by full
    iteration over every slot (K3/K4: ``capacity=0`` without ``lists``,
    the reference's ``tile_list_capacity=0``). Both give the same bits.

    CUDA tensors launch ``csrc/raster.cu``; CPU tensors run
    :func:`rasterize_plain`. Any other device raises."""
    kind = setup.coeffs.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no raster for device type {kind!r}")
    if lists is None and capacity:
        lists = bin_triangles(setup.coeffs, height, width, capacity)
    if kind == "cpu":
        return rasterize_plain(setup, width, height, depth_only, origin, lists, full=lists is None)
    return _launch_kernel(setup, lists, height, width, depth_only, origin)
