"""The least work of a frame's quirk-exact aerial integrals.

Counted from the scene with the benchmark's own arithmetic (the plain
reference's frame state, camera raster and camera rays), never from the
program's tensors or launches, so the count is the same whatever
computes the integrals:

* pixels: those of the frame (its ``render_width`` x ``render_height``
  rows and columns) whose camera ray meets geometry (reference depth not
  0) or, failing that, the planet; a ray into the sky needs no integral;
* per counted pixel, one in-scattering integral of
  :data:`STEPS` steps (``common.glinl:363-424``); the metallic bounce's
  second integral is not counted, so the count stays a lower bound
  whatever a kernel skips;
* operations: :data:`OPS_PER_STEP` a step, below;
* bytes: per counted pixel, the surface position read (12 B, f32 xyz)
  and the integral written (12 B, f32 rgb); the transmittance LUT
  (256 KiB) lives in L2 and is not counted.

The least time is the larger of bytes over the memory bandwidth and
operations over the f32 rate outside the tensor cores
(:mod:`frame_bench.roofline`).

Operations a step, from the reference's step
(``reference/kernels/atmosphere.py``: ``_march_step`` and the
accumulation of ``luminance_scattering_integral``), counted as written:
each add, subtract, multiply, divide, square root, exponential, absolute
value, floor, min, max (a clamp to both bounds is two) on an f32 value
that varies with the pixel or the step, a transcendental counted as one;
an expression written twice counted once; free: values that depend only
on the atmosphere, the LUT's size or the step's index, values that stay
the same over a pixel's steps (the ray's set-up), negations, comparisons,
selects, integer index arithmetic and the LUT's texel reads. ``U`` is one
transmittance-LUT sample ``sample_transmittance_rmu(radius, mu)``:
``transmittance_rmu_to_uv`` 24 (rho 4, d 9, d_min 1, d_max 1, x_mu 4,
x_radius 1, two texture coordinates 4) and ``sample_lut_bilinear`` 41
(x and y 4 each, two floors, two fractions, ``1 - fx`` and ``1 - fy``,
three lerps of three channels at 3 each), U = 65. Of a step's two
samples at the step's radius, the radius's part (rho 4, d_min 1, d_max
1, x_radius 1, v 2, y 4, its floor and fraction 2, ``1 - fy`` 1) is
written the same in both: 16 counted once.
"""

from __future__ import annotations

import torch

from frame_bench.roofline import Work

STEPS = 32  # SKYVIEW_SAMPLES, common.glinl:363
U = 24 + 41  # one transmittance-LUT sample, above
SHARED_RADIUS = 16  # the part of two samples at one radius written the same

# the reference's step, term by term (operations per pixel and step)
STEP_TERMS = {
    "t = i * d_sample": 1,
    "begin = origin - t * scattering_dir": 6,
    "end = origin - (i + 1) * d_sample * scattering_dir": 7,
    "step_radius_mu: radius 6, clamp 1, mu 2, mu_sun 3": 12,
    "altitude = |begin| - R": 8,
    "sample_transmittance_sun: horizon 5, edges 2, x 2, t 6, smoothstep 4, product 3, and U": 22 + U,
    "sample_extinction: clamp 1, two densities 4, four products 12, ozone 6, its two products 6, sum 15": 44,
    "s_end = U at the step's radius, less the shared radius part": U - SHARED_RADIUS,
    "t_begin: both ratios with their clamps and the clamp to [0, 1], 5 a channel": 15,
    "t_path = sample_transmittance_segment: direction 13, flip 5, two ray samples 35 and 2 U, ratio 12": 65 + 2 * U,
    "integral = (1 - t_path) / extinction, 3 a channel": 9,
    "phase_scat = scat_r * phase_r + scat_m * phase_m": 9,
    "luminance += phase_scat * t_sun * integral * t_begin": 12,
}
OPS_PER_STEP = sum(STEP_TERMS.values())
POSITION_BYTES = 3 * 4  # the surface position read, f32 xyz
RESULT_BYTES = 3 * 4  # the integral written, f32 rgb


def counted_pixels(depth, position, direction, planet_radius) -> int:
    """The pixels whose ray meets geometry (``depth`` not 0) or, failing
    that, the planet of ``planet_radius`` (Mm): ``depth`` (h, w), the
    camera ``position`` (3,) and view ``direction`` (h, w, 3) in sky
    space."""
    from frame_bench.reference.kernels.atmosphere import ray_sphere_intersect_fma

    hit, t0, _ = ray_sphere_intersect_fma(position.expand(direction.shape), direction, planet_radius)
    counted = (depth != 0.0) | (hit & (t0 > 0.0))
    return int(counted.sum().item())


def work_of(pixels: int) -> Work:
    """The least work of ``pixels`` integrals."""
    return Work(
        bytes=float(pixels * (POSITION_BYTES + RESULT_BYTES)),
        ops=float(pixels * STEPS * OPS_PER_STEP),
    )


def aerial_work(geometry, params, config) -> Work:
    """The least work of one frame's integrals. ``geometry``, ``params``
    and ``config`` are the reference's (:mod:`frame_bench.reference`)."""
    from frame_bench.reference.kernels.raster import rasterize, setup_triangles
    from frame_bench.reference.kernels.resolve import transform_positions
    from frame_bench.reference.kernels.sky import camera_rays
    from frame_bench.reference.math.geometry import matmul4
    from frame_bench.reference.scene.pack import prepare_frame_state

    with torch.no_grad():
        state = prepare_frame_state(params)
        cam = state.camera
        clip, _ = transform_positions(
            geometry.positions, geometry.vert_instance, state.models, matmul4(cam.projection, cam.view)
        )
        w, h = config.render_width, config.render_height
        setup = setup_triangles(
            clip, geometry.triangles, geometry.tri_valid, w, h, cull_keep_sign=+1,
            grid_width=config.padded_width, grid_height=config.padded_height,
        )
        depth = rasterize(setup, config.padded_width, config.padded_height).depth[:h, :w]
        position, direction, _, _ = camera_rays(cam, state.atmosphere, h, w, (w, h))
        return work_of(counted_pixels(depth, position, direction, state.atmosphere.planet_radius_mm))
