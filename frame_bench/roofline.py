"""The chip's peaks and the least work of a frame's rasters.

Counted from the scene and the raster targets with the benchmark's own
arithmetic (the plain reference's frame state, vertex transforms, light
activity and triangle setup), never from the program's tile lists or
launches, so the count is the same whatever raster implements it:

* bytes: each valid triangle slot's three screen-space vertices (x, y,
  z in f32) read once, plus each target's outputs written once: depth
  and id (4 + 4 B) per camera pixel, depth (4 B) per texel of each shadow
  map that the frame samples;
* operations: 16 per pixel centre inside each valid slot's screen box,
  clipped to its target.

The least time is the larger of bytes over the memory bandwidth and
operations over the f32 rate outside the tensor cores.
"""

from __future__ import annotations

import dataclasses

import torch

# NVIDIA H100 SXM data sheet, at its full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

OPS_PER_PIXEL = 16
VERTEX_BYTES = 3 * 3 * 4  # three (x, y, z) f32 vertices per slot
CAMERA_BYTES_PER_PIXEL = 4 + 4  # depth and id
SHADOW_BYTES_PER_TEXEL = 4  # depth


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    ops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)

    @property
    def least_s(self) -> float:
        return max(self.bytes / PEAK_BYTES_PER_S, self.ops / PEAK_F32_FLOPS)


def _centres(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Pixel centres i + 0.5, 0 <= i < n, inside [lo, hi] (f64 counts)."""
    first = torch.clamp(torch.ceil(lo.double() - 0.5), min=0)
    last = torch.clamp(torch.floor(hi.double() - 0.5), max=n - 1)
    return torch.clamp(last - first + 1, min=0)


def _target_work(cols: torch.Tensor, width: int, height: int, out_bytes: int) -> Work:
    valid = cols[:, 9] > 0
    c = cols[valid]
    boxes = _centres(c[:, 10], c[:, 11], width) * _centres(c[:, 12], c[:, 13], height)
    return Work(
        bytes=float(valid.sum().item() * VERTEX_BYTES + width * height * out_bytes),
        ops=float(boxes.sum().item() * OPS_PER_PIXEL),
    )


def raster_work(geometry, params, config) -> Work:
    """The least raster work of one frame: the camera target and every
    shadow map the frame samples. ``geometry``, ``params`` and ``config``
    are the reference's (:mod:`frame_bench.reference`)."""
    from frame_bench.reference.kernels.lighting import light_activity
    from frame_bench.reference.kernels.raster import _setup_slots
    from frame_bench.reference.kernels.resolve import transform_positions
    from frame_bench.reference.math.geometry import matmul4, matvec
    from frame_bench.reference.scene.pack import prepare_frame_state

    with torch.no_grad():
        state = prepare_frame_state(params)
        cam = state.camera
        clip, world = transform_positions(
            geometry.positions, geometry.vert_instance, state.models, matmul4(cam.projection, cam.view)
        )
        cols, _, _ = _setup_slots(
            clip[geometry.triangles.long()], geometry.tri_valid,
            config.render_width, config.render_height, +1,
        )
        work = _target_work(cols, config.render_width, config.render_height, CAMERA_BYTES_PER_PIXEL)
        active = light_activity(
            state.directional_lights, state.directional_count, state.directional_skip_count,
            state.spot_lights, state.spot_count, config.shadowless_strength_eps, config.n_shadow_maps,
        ).shadow_maps.tolist()
        d, s = state.directional_lights, state.spot_lights
        pv = torch.cat([matmul4(d.projection, d.view), matmul4(s.projection, s.view)], dim=0)
        world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
        corners = world_h[geometry.triangles.long()]
        casters = geometry.tri_valid & geometry.tri_casts_shadow
        dim = config.shadow_dim
        for i, on in enumerate(active):
            if on:
                cols, _, _ = _setup_slots(
                    matvec(pv[i], corners), casters, dim, dim, -1,
                    config.shadow_bias_constant, config.shadow_bias_slope,
                )
                work = work + _target_work(cols, dim, dim, SHADOW_BYTES_PER_TEXEL)
    return work
