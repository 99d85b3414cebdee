"""Engine geometry conventions and matrix constructors, in torch.

Port of ``syzygy_tpu/math/geometry.py``: row-major matrices acting on column
vectors, float32, leading batch dims allowed on every input. Conventions
(``geometryhelpers.hpp:16-29``): +x right, +y DOWN, +z forward; reverse-Z;
euler angles are (pitch, roll, yaw) and ``orientate4`` is
``RotY(yaw) @ RotX(pitch) @ RotZ(roll)``.

Constants are built on the caller's device (``world_up(device)``) so no
function reads a global default device.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple

import numpy as np
import torch

from syzygy_tpu_torch.device import constant

F32 = torch.float32


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. torch's vectorized CPU ``sqrt`` can be
    1 ulp off; near the horizon the atmosphere LUT mappings turn one ulp of
    a ray direction into ~1e-3 of transmittance. Taking the root in
    float64 and rounding once to float32 is exact (53 >= 2 * 24 + 2 bits),
    on the CPU and on the GPU alike."""
    return torch.sqrt(x.double()).to(x.dtype)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add ``a * b + c`` with one rounding (the f32
    product is exact in float64, the float64 sum is rounded once more to
    f32; a sum that lands exactly on an f32 rounding tie can round twice,
    rarer than 1 in 2^29). Only the operand of most dimensions is cast
    first (under PyTorch's promotion a dimensioned f32 operand would win
    over a 0-dim float64 one); ``addcmul`` casts the others as it reads
    them, so this is three kernels on a GPU, not six."""
    ops = [a, b, c]
    wide = max(range(3), key=lambda i: ops[i].dim())
    ops[wide] = ops[wide].double()
    return torch.addcmul(ops[2], ops[0], ops[1]).float()


def dot3_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b, -1)`` over 3 components as the reference's XLA CPU
    compiles a short reduction: ``fma(a2, b2, fma(a1, b1, a0 * b0))``
    (torch's sum of rounded products can differ from it in the last
    bit)."""
    return fma32(a[..., 2], b[..., 2], fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def vec_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm as ``sqrt(sum(v * v))`` (``jnp.linalg.norm``'s form)."""
    return sqrt_rn(torch.sum(v * v, dim=dim, keepdim=keepdim))


# The reference's world axes as CPU constants; device code reads the
# shared copy on its own device (world_forward/world_up/world_right(device),
# device.constant): never write to it.
_FORWARD, _UP, _RIGHT = (0.0, 0.0, 1.0), (0.0, -1.0, 0.0), (1.0, 0.0, 0.0)
WORLD_FORWARD = torch.tensor(_FORWARD, dtype=F32)
WORLD_UP = torch.tensor(_UP, dtype=F32)
WORLD_RIGHT = torch.tensor(_RIGHT, dtype=F32)


def _f32(x) -> torch.Tensor:
    """An f32 tensor of ``x`` (a tensor keeps its device; anything else
    lands on the CPU)."""
    return x.to(F32) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32))


def world_forward(device) -> torch.Tensor:
    return constant(_FORWARD, F32, device)


def world_up(device) -> torch.Tensor:
    return constant(_UP, F32, device)


def world_right(device) -> torch.Tensor:
    return constant(_RIGHT, F32, device)


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` over the last axes, (..., R, K) x (..., K) -> (..., R), for
    K = 3 or 4, summed as ``(p0 + p1) + (p2 + p3)`` without fused
    multiply-adds.

    The reference's small products run through XLA's CPU dot, whose
    summation order depends on the shape: a point array times a shared
    matrix (``points @ m.T``) sums pairwise like this, batched products
    (:func:`matvec_fma`, :func:`matmul4`) chain fused multiply-adds.
    Matching the order keeps vertex positions, and so raster coverage at
    triangle edges, bitwise equal to the reference's."""
    p = m * v[..., None, :]
    if p.shape[-1] == 4:
        return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
    if p.shape[-1] == 3:
        return (p[..., 0] + p[..., 1]) + p[..., 2]
    raise ValueError(f"matvec supports K = 3 or 4, got {p.shape[-1]}")


def matvec_fma(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` over the last axes as a fused multiply-add chain,
    ``fma(m[K-1] v[K-1], ... fma(m1 v1, m0 v0))``. Each fma is evaluated
    in float64 (the f32 product is exact there) and rounded once to f32."""
    v = v[..., None, :]
    acc = m[..., 0] * v[..., 0]
    for k in range(1, m.shape[-1]):
        acc = (m[..., k].double() * v[..., k].double() + acc.double()).float()
    return acc


def matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4) as :func:`matvec_fma` chains."""
    # out[i, j] = sum_k a[i, k] * b[k, j]: row i of ``a`` against b's columns
    return matvec_fma(b.transpose(-1, -2)[..., None, :, :], a)


def _compose4(entries) -> torch.Tensor:
    """Stack a 4x4 from 16 (possibly batched) scalar tensors, row-major."""
    batch = torch.broadcast_shapes(*[e.shape for e in entries])
    flat = torch.stack([e.expand(batch) for e in entries], dim=-1)
    return flat.reshape(*batch, 4, 4)


def _rotate_x_cs(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _compose4([o, z, z, z, z, c, -s, z, z, s, c, z, z, z, z, o])


def _rotate_y_cs(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _compose4([c, z, s, z, z, o, z, z, -s, z, c, z, z, z, z, o])


def _rotate_z_cs(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _compose4([c, -s, z, z, s, c, z, z, z, z, o, z, z, z, z, o])


def rotate_x(a: torch.Tensor) -> torch.Tensor:
    return _rotate_x_cs(torch.cos(a), torch.sin(a))


def rotate_y(a: torch.Tensor) -> torch.Tensor:
    return _rotate_y_cs(torch.cos(a), torch.sin(a))


def rotate_z(a: torch.Tensor) -> torch.Tensor:
    return _rotate_z_cs(torch.cos(a), torch.sin(a))


def orientate4(e: torch.Tensor) -> torch.Tensor:
    """GLM ``orientate4``: RotY(yaw) @ RotX(pitch) @ RotZ(roll)."""
    return matmul4(matmul4(rotate_y(e[..., 2]), rotate_x(e[..., 0])), rotate_z(e[..., 1]))


def forward_from_eulers(e: torch.Tensor) -> torch.Tensor:
    """``forwardFromEulers`` (``geometryhelpers.cpp:102-105``)."""
    pitch, yaw = e[..., 0], e[..., 2]
    cp = torch.cos(pitch)
    return torch.stack(
        [torch.sin(yaw) * cp, -torch.sin(pitch), torch.cos(yaw) * cp], dim=-1
    )


def _asin_xla(x: torch.Tensor) -> torch.Tensor:
    """``asin`` as the reference's XLA computes it on the CPU: ``2 *
    atan2(x, 1 + sqrt((1 - x) * (1 + x)))`` in f32, whose ``atan2`` is
    glibc's ``atan2f`` (``torch.asin`` can differ from it in the last
    bit). torch's ``atan2`` calls the same ``atan2f`` for the elements
    of a CPU tensor outside its vectorized loop, i.e. for a single vector
    such as a camera's forward; its vectorized ``atan2`` can differ from
    it in the last bit."""
    half = torch.atan2(x, sqrt_rn((1.0 - x) * (x + 1.0)) + 1.0)
    return half + half


def eulers_from_forward(forward: torch.Tensor) -> torch.Tensor:
    """``eulersFromForward`` (``geometryhelpers.cpp:107-145``): (pitch, 0,
    yaw); a degenerate zero-length input maps to zeros."""
    dev = forward.device
    length_sq = torch.sum(forward * forward, dim=-1, keepdim=True)
    safe = length_sq > torch.finfo(F32).eps
    fn = torch.where(safe, forward * (1.0 / sqrt_rn(length_sq)), 0.0)
    dot_forward = torch.sum(fn * world_forward(dev), dim=-1)
    dot_right = torch.sum(fn * world_right(dev), dim=-1)
    dot_up = torch.sum(fn * world_up(dev), dim=-1)
    pitch = _asin_xla(torch.clamp(dot_up, -1.0, 1.0))
    yaw = torch.atan2(dot_right, dot_forward)
    eulers = torch.stack([pitch, torch.zeros_like(pitch), yaw], dim=-1)
    return torch.where(safe, eulers, 0.0)


def inverse4(m: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse of (..., 4, 4) matrices (the same
    adjugate formula as the reference, so results agree to rounding)."""
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (
            a[r0][c0] * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
            - a[r0][c1] * (a[r1][c0] * a[r2][c2] - a[r1][c2] * a[r2][c0])
            + a[r0][c2] * (a[r1][c0] * a[r2][c1] - a[r1][c1] * a[r2][c0])
        )

    rows = (0, 1, 2, 3)
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = [r for r in rows if r != i]
        for j in range(4):
            cj = [c for c in rows if c != j]
            minor = det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
            cof[i][j] = minor if (i + j) % 2 == 0 else -minor
    det = (
        a[0][0] * cof[0][0]
        + a[0][1] * cof[0][1]
        + a[0][2] * cof[0][2]
        + a[0][3] * cof[0][3]
    )
    inv_det = 1.0 / det
    flat = torch.stack(
        [cof[j][i] * inv_det for i in range(4) for j in range(4)], dim=-1
    )
    return flat.reshape(*m.shape[:-2], 4, 4)


def translate(t: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(4, dtype=F32, device=t.device)
    out = eye.expand(*t.shape[:-1], 4, 4).clone()
    out[..., 0:3, 3] = t
    return out


def scale_matrix(s: torch.Tensor) -> torch.Tensor:
    o = torch.ones_like(s[..., 0])
    z = torch.zeros_like(o)
    return _compose4(
        [s[..., 0], z, z, z, z, s[..., 1], z, z, z, z, s[..., 2], z, z, z, z, o]
    )


def transform_vk(position, euler_angles) -> torch.Tensor:
    """``transformVk`` (``geometryhelpers.cpp:147-151``): translate @ orientate4."""
    return matmul4(translate(_f32(position)), orientate4(_f32(euler_angles)))


def transform_to_matrix(translation, euler_angles, scale) -> torch.Tensor:
    """``Transform::toMatrix`` (``geometry/transform.cpp:11-15``): T @ R @ S."""
    return matmul4(
        matmul4(translate(_f32(translation)), orientate4(_f32(euler_angles))), scale_matrix(_f32(scale))
    )


def view_vk(position: torch.Tensor, euler_angles: torch.Tensor):
    """``viewVk`` = inverse(transformVk), computed as R^T @ T(-p)."""
    rot_t = orientate4(euler_angles).transpose(-1, -2)
    return matmul4(rot_t, translate(-position))


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    return lib


def orientate4_host(euler_angles) -> torch.Tensor:
    """:func:`orientate4` of one host euler triple as the reference
    computes it outside ``jit`` (``Camera.rotation``): its eager XLA CPU
    ``sin``/``cos`` are glibc's ``sinf``/``cosf``, which torch's CPU
    ``sin``/``cos`` differ from in the last bit on a few percent of
    inputs. A CPU tensor."""
    lib = _libm()
    e = [float(x) for x in np.asarray(euler_angles, np.float32)]

    def rot(fn, a):
        return fn(torch.tensor(lib.cosf(a), dtype=F32), torch.tensor(lib.sinf(a), dtype=F32))

    return matmul4(matmul4(rot(_rotate_y_cs, e[2]), rot(_rotate_x_cs, e[0])), rot(_rotate_z_cs, e[1]))


def _normalize(v, eps=1e-20):
    return v / sqrt_rn(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def look_at_vk(eye, center, up) -> torch.Tensor:
    """``lookAtVk`` (``geometryhelpers.cpp:63-68``): scale(1,-1,-1) @ lookAtRH."""
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up.expand_as(f)))
    u = torch.linalg.cross(s, f)
    z = torch.zeros_like(f[..., 0])
    o = torch.ones_like(z)
    look_rh = _compose4(
        [
            s[..., 0], s[..., 1], s[..., 2], -_dot(s, eye),
            u[..., 0], u[..., 1], u[..., 2], -_dot(u, eye),
            -f[..., 0], -f[..., 1], -f[..., 2], _dot(f, eye),
            z, z, z, o,
        ]
    )
    flip = scale_matrix(constant([1.0, -1.0, -1.0], F32, eye.device))
    return matmul4(flip, look_rh)


def look_at_vk_safe(eye, center) -> torch.Tensor:
    """``lookAtVkSafe`` (``geometryhelpers.cpp:70-81``)."""
    dev = eye.device
    cosine = torch.sum(world_forward(dev) * world_up(dev))
    up = torch.where(
        torch.abs(cosine) > 0.99,
        world_forward(dev) * torch.sign(cosine),
        world_up(dev),
    )
    return look_at_vk(eye, center, up)


def quat_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """The quaternion (w, x, y, z) of :func:`random_quat` from its four
    uniforms in [0, 1), drawn in the reference's order (r1, theta1, r2,
    theta2): two polar samples of the unit disk, (x, y) and (u, v),
    joined as (s v, x, y, s u) with s = sqrt((1 - |xy|^2) / |uv|^2)."""

    def disk(r_draw, theta_draw):
        r = sqrt_rn(r_draw)
        theta = theta_draw * 2.0 * np.pi
        return torch.stack([r * torch.cos(theta), r * torch.sin(theta)])

    xy = disk(u[0], u[1])
    uv = disk(u[2], u[3])
    s = sqrt_rn((1.0 - torch.sum(xy * xy)) / torch.clamp(torch.sum(uv * uv), min=1e-12))
    return torch.stack([s * uv[1], xy[0], xy[1], s * uv[0]])


def random_quat(generator: torch.Generator, device) -> torch.Tensor:
    """``randomQuat`` (``geometryhelpers.cpp:159-169``): a uniformly random
    rotation quaternion (w, x, y, z) on ``device``. ``generator`` takes the
    place of the reference's PRNG key; its four uniforms are drawn on the
    generator's own device, in the reference's order."""
    u = torch.rand(4, generator=generator, dtype=F32, device=generator.device)
    return quat_from_uniforms(u.to(device))


def perspective_vk(fov_y_degrees, aspect_ratio, near, far) -> torch.Tensor:
    """``projectionVk`` (``geometryhelpers.cpp:83-95``): perspectiveLH_ZO
    with near/far swapped (reverse-Z). Arguments are f32 tensors."""
    fov = torch.deg2rad(fov_y_degrees)
    t = torch.tan(fov / 2.0)
    z_near, z_far = far, near
    shape = torch.broadcast_shapes(t.shape, aspect_ratio.shape, near.shape, far.shape)
    t = t.expand(shape)
    z = torch.zeros_like(t)
    o = torch.ones_like(t)
    return _compose4(
        [
            1.0 / (aspect_ratio * t), z, z, z,
            z, 1.0 / t, z, z,
            z, z, (z_far / (z_far - z_near)).expand(shape),
            (-(z_far * z_near) / (z_far - z_near)).expand(shape),
            z, z, o, z,
        ]
    )


def projection_ortho_vk(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """``projectionOrthoVk`` (``geometryhelpers.cpp:97-100``)."""
    left, right = mn[..., 0], mx[..., 0]
    bottom, top = mn[..., 1], mx[..., 1]
    z_near, z_far = mx[..., 2], mn[..., 2]
    z = torch.zeros_like(left)
    o = torch.ones_like(left)
    return _compose4(
        [
            2.0 / (right - left), z, z, -(right + left) / (right - left),
            z, 2.0 / (top - bottom), z, -(top + bottom) / (top - bottom),
            z, z, 1.0 / (z_far - z_near), -z_near / (z_far - z_near),
            z, z, z, o,
        ]
    )


class AABB(NamedTuple):
    """Axis-aligned box as center + half extent."""

    center: torch.Tensor  # (..., 3)
    half_extent: torch.Tensor  # (..., 3)

    def collect_vertices(self) -> torch.Tensor:
        signs = constant(
            [
                [sx, sy, sz]
                for sx in (-1.0, 1.0)
                for sy in (-1.0, 1.0)
                for sz in (-1.0, 1.0)
            ],
            F32,
            self.center.device,
        )
        return self.center[..., None, :] + self.half_extent[..., None, :] * signs


def aabb_from_min_max(min_v, max_v) -> AABB:
    mn, mx = _f32(min_v), _f32(max_v)
    return AABB(center=(mn + mx) * 0.5, half_extent=(mx - mn) * 0.5)


def project_point_on_plane(plane_point, plane_normal, point) -> torch.Tensor:
    """``projectPointOnPlane`` (``geometryhelpers.cpp:55-61``), reproducing
    the reference's quirk: it ADDS the normal component."""
    to_point = point - plane_point
    return torch.sum(to_point * plane_normal, dim=-1, keepdim=True) * plane_normal + point


def ortho_aabb_vk(view: torch.Tensor, bounds: AABB) -> torch.Tensor:
    """``projectionOrthoAABBVk`` (``geometryhelpers.cpp:171-204``)."""
    verts = bounds.collect_vertices()  # (..., 8, 3)
    ones = torch.ones((*verts.shape[:-1], 1), dtype=F32, device=verts.device)
    verts_h = torch.cat([verts, ones], dim=-1)
    verts_view = matvec(view[..., None, :, :], verts_h)[..., :3]
    center_h = torch.cat(
        [bounds.center, torch.ones((*bounds.center.shape[:-1], 1), dtype=F32, device=verts.device)],
        dim=-1,
    )
    center_view = matvec(view, center_h)[..., :3]
    projected = project_point_on_plane(
        center_view[..., None, :], world_forward(verts.device), verts_view
    )
    view_min = torch.amin(projected, dim=-2)
    view_max = torch.amax(projected, dim=-2)
    return projection_ortho_vk(view_min, view_max)
