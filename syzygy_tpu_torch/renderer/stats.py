"""Per-frame draw statistics (``DrawResultsGraphics``).

Port of ``syzygy_tpu/renderer/stats.py``: the reference engine counts draw
calls, vertices and indices while it records its pipelines
(``renderer/pipelines.hpp:39-44``, ``pipelines.cpp:577-580``) and shows them
in its UI. Here a frame is a handful of whole-soup dispatches, so each
dispatch counts as one "draw call" over the triangles it consumes:

* ``gbuffer``: the camera visibility raster, 1 call over every valid
  triangle of the packed soup;
* ``shadows``: one call per shadow-map raster that will run, by the gate of
  ``renderer/frame.py::_shadow_pass`` (map 0 always; other directionals
  skipped when they emit nothing or, under ``shadowless_strength_eps``,
  when too dim; spots up to the map budget), each over the shadow-casting
  subset;
* ``debug_lines``: 1 call, vertices = indices = 2 x segment count.

Host math over the frame's ``FrameParams`` (numpy) and the packed
geometry; no device work beyond the sun and moon bake on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DrawStats(NamedTuple):
    """``DrawResultsGraphics`` (``renderer/pipelines.hpp:39-44``)."""

    draw_calls: int
    vertices_drawn: int
    indices_drawn: int

    def __str__(self) -> str:  # engineui.cpp:111-126 row labels
        return (
            f"draw calls {self.draw_calls}, vertices {self.vertices_drawn}, "
            f"indices {self.indices_drawn}"
        )


def _add(a: DrawStats, b: DrawStats) -> DrawStats:
    return DrawStats(*[x + y for x, y in zip(a, b)])


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def frame_draw_stats(params, geometry, config) -> dict[str, DrawStats]:
    """Counters for every dispatch of the next ``render_frame``.
    ``params`` is the frame's ``FrameParams`` (host numpy or uploaded),
    ``geometry`` the packed ``GeometryStatic`` or the host dict of
    ``pack_geometry_host``, ``config`` the ``RenderConfig``."""
    from syzygy_tpu_torch.device import to_tensor
    from syzygy_tpu_torch.math.geometry import world_up
    from syzygy_tpu_torch.renderer.frame import N_DIRECTIONAL
    from syzygy_tpu_torch.scene.atmosphere import bake_directional

    def field(name):
        return _host(geometry[name] if isinstance(geometry, dict) else getattr(geometry, name))

    tri_valid = field("tri_valid")
    n_tris = int(tri_valid.sum())
    n_shadow_tris = int((tri_valid & field("tri_casts_shadow")).sum())
    n_verts = int(field("positions").shape[0])

    stats: dict[str, DrawStats] = {"gbuffer": DrawStats(1, n_verts, 3 * n_tris)}

    # the shadow pass's activity gate over the baked sun and moon
    d = bake_directional(
        type(params.atmosphere)(*[to_tensor(_host(x), "cpu") for x in params.atmosphere]),
        to_tensor(_host(params.bounds_min), "cpu"),
        to_tensor(_host(params.bounds_max), "cpu"),
    )
    color = d.color.numpy()[:, :3]
    dir_int = np.max(np.abs(color), axis=-1) * np.abs(d.strength.numpy())
    eps = config.shadowless_strength_eps
    if eps > 0.0:
        daylight = np.clip(np.sum(-d.forward.numpy()[:, :3] * world_up("cpu").numpy(), axis=-1), 0.0, 1.0)
        dir_needs = dir_int >= eps * float(np.sum(dir_int * daylight))
    else:
        dir_needs = dir_int != 0.0
    dir_needs[0] = True  # the sun always rasters (the sky pass samples map 0)
    n_maps = config.n_shadow_maps
    n_dir = int(np.sum(dir_needs[: min(N_DIRECTIONAL, n_maps)]))
    n_spot = min(int(_host(params.spot_count)), max(0, n_maps - N_DIRECTIONAL))
    shadow_calls = n_dir + n_spot
    stats["shadows"] = DrawStats(shadow_calls, shadow_calls * n_verts, shadow_calls * 3 * n_shadow_tris)

    n_seg = int(_host(params.debug_valid).sum())
    stats["debug_lines"] = DrawStats(1, 2 * n_seg, 2 * n_seg) if n_seg else DrawStats(0, 0, 0)

    stats["total"] = DrawStats(0, 0, 0)
    for key in ("gbuffer", "shadows", "debug_lines"):
        stats["total"] = _add(stats["total"], stats[key])
    return stats
