"""Debug line overlay: wireframe boxes drawn over the scene texture.

Port of ``syzygy_tpu/kernels/debuglines.py`` (``DebugLineGraphicsPipeline``,
``renderer/pipelines.cpp:382-591``, ``shaders/debug/debugline.vert/.frag``):
line-list geometry transformed by the camera, drawn constant green with a
reverse-Z depth test against the scene depth buffer. Each segment is a
capsule test over the pixel grid; segments are few (scene bounds and
instance boxes).
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
LINE_COLOR = (0.0, 1.0, 0.0)  # debugline.vert:35

BOX_EDGES = np.array(
    [
        [0, 1], [1, 3], [3, 2], [2, 0],  # -z face (per AABB vertex order)
        [4, 5], [5, 7], [7, 6], [6, 4],  # +z face
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int32,
)


def box_segments(center, half_extent) -> np.ndarray:
    """12 edges of an axis-aligned box -> (12, 2, 3) world segments
    (``DebugLines::pushBox``)."""
    center = np.asarray(center, np.float32)
    half = np.asarray(half_extent, np.float32)
    signs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32
    )
    return (center[None, :] + half[None, :] * signs)[BOX_EDGES]


def line_coverage(depth_buffer, segments, segments_valid, proj_view, draw_extent, line_width: float = 1.0):
    """(H, W) bool: pixels some valid segment covers and wins the
    ``z >= depth`` test at (``debuglines.py:54-94``). Each segment costs a
    few tensor ops over the grid, so the loop is over segments."""
    h, w = depth_buffer.shape
    dev = depth_buffer.device
    draw_w, draw_h = draw_extent
    seg = segments.to(F32)
    clip = torch.cat([seg, torch.ones_like(seg[..., :1])], dim=-1) @ proj_view.T  # (S, 2, 4)
    w_clip = clip[..., 3]
    visible = (w_clip > 1e-3).all(dim=-1) & segments_valid
    ndc = clip[..., :3] / torch.clamp(w_clip, min=1e-3)[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * draw_w  # (S, 2)
    sy = (ndc[..., 1] * 0.5 + 0.5) * draw_h
    sz = ndc[..., 2]
    px = torch.arange(w, dtype=F32, device=dev)[None, :] + 0.5
    py = torch.arange(h, dtype=F32, device=dev)[:, None] + 0.5
    radius_sq = (0.5 * line_width + 0.5) ** 2

    overlay = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for s in torch.nonzero(visible).flatten().tolist():  # an invisible segment covers nothing
        ax, ay, az = sx[s, 0], sy[s, 0], sz[s, 0]
        dx, dy = sx[s, 1] - ax, sy[s, 1] - ay
        len_sq = torch.clamp(dx * dx + dy * dy, min=1e-8)
        t = torch.clamp(((px - ax) * dx + (py - ay) * dy) / len_sq, 0.0, 1.0)
        dist_sq = (px - (ax + t * dx)) ** 2 + (py - (ay + t * dy)) ** 2
        z = az + t * (sz[s, 1] - az)
        overlay |= (dist_sq <= radius_sq) & (z >= depth_buffer) & (z <= 1.0)  # reverse-Z GREATER_OR_EQUAL
    return overlay


def draw_lines(color_image, depth_buffer, segments, segments_valid, proj_view, draw_extent,
               line_width: float = 1.0):
    """Composite depth-tested green lines over the (H, W, 3) color image
    (``debuglines.py:44-98``)."""
    overlay = line_coverage(depth_buffer, segments, segments_valid, proj_view, draw_extent, line_width)
    green = torch.tensor(LINE_COLOR, dtype=color_image.dtype, device=color_image.device)
    return torch.where(overlay[..., None], green, color_image)
