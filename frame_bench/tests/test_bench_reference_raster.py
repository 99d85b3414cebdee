"""The reference's block raster is bitwise the port's plain raster
(``kernels/raster.py::rasterize_plain``, itself bitwise the CUDA kernel
on the card): a sliver whose f32 test passes far outside its tile range,
depth ties between coplanar copies, and the chess scene's camera and sun
setups, visibility and depth-only."""

import numpy as np
import pytest
import torch
from conftest import CELLS, SEED, small_cell

from frame_bench.check import reference_frames
from frame_bench.reference.kernels import raster as ref
from frame_bench.reference.kernels.resolve import transform_positions
from frame_bench.reference.math.geometry import matmul4, matvec
from frame_bench.reference.scene.pack import prepare_frame_state
from syzygy_tpu_torch.kernels import raster as port

W, H = 256, 192


def _port_setup(setup):
    return port.TriSetup(setup.coeffs, setup.orig_tri, setup.corner_bary, setup.corner_w, None)


def _sliver():
    """One valid sliver (doubled area 2e-12) beside an ordinary triangle,
    its coefficient row built from exact corners as ``_setup_slots`` does."""
    x0, y0, x1, y1 = 0.5, 0.5, 60.5, 30.5
    x2, y2 = 30.5, 15.5 + 2e-12 / 60.0
    inv = 1.0 / ((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0))
    sliver = [
        ((y2 - y1) * x1 - (x2 - x1) * y1) * inv, -(y2 - y1) * inv, (x2 - x1) * inv,
        ((y0 - y2) * x2 - (x0 - x2) * y2) * inv, -(y0 - y2) * inv, (x0 - x2) * inv,
        0.5, 0.0, 0.0, 1.0, x0, x1, y0, y1,
    ]
    inf = float("inf")
    rows = [sliver, [0.0] * 10 + [inf, -inf, inf, -inf]]
    cols = torch.tensor(rows, dtype=torch.float64).float()
    return ref._finish_setup(cols, torch.zeros((2, 3, 2)), torch.ones((2, 3)), W, H, (0, 0))


def _random(copies=2):
    """Screen triangles from clip corners (w = 1), each repeated
    ``copies`` times: exact depth ties between coplanar copies."""
    rng = np.random.default_rng(5)
    xy = rng.uniform(-1.1, 1.1, size=(300, 1, 2)) + rng.uniform(-0.3, 0.3, size=(300, 3, 2))
    z = rng.uniform(0.05, 0.95, size=(300, 3, 1))
    clip = np.concatenate([xy, z, np.ones((300, 3, 1))], axis=-1).astype(np.float32)
    clip = torch.from_numpy(np.concatenate([clip] * copies))
    return ref.setup_triangles(None, torch.zeros((clip.shape[0], 3), dtype=torch.int32),
                               torch.ones(clip.shape[0], dtype=torch.bool), W, H, 0, corner_clip=clip)


def _scene_setups():
    geometry, params, config = next(reference_frames(small_cell(CELLS[1]), SEED, torch.device("cpu"), [3]))[1:]
    state = prepare_frame_state(params)
    cam = state.camera
    clip, world = transform_positions(geometry.positions, geometry.vert_instance, state.models,
                                      matmul4(cam.projection, cam.view))
    camera = ref.setup_triangles(clip, geometry.triangles, geometry.tri_valid, config.render_width,
                                 config.render_height, +1, grid_width=config.padded_width,
                                 grid_height=config.padded_height)
    d = state.directional_lights
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    sun = ref.setup_triangles(None, geometry.triangles, geometry.tri_valid & geometry.tri_casts_shadow,
                              config.shadow_dim, config.shadow_dim, -1,
                              corner_clip=matvec(matmul4(d.projection, d.view)[0], world_h[geometry.triangles.long()]))
    return [(camera, config.padded_width, config.padded_height), (sun, config.shadow_dim, config.shadow_dim)]


def _cases():
    return [(_sliver(), W, H), (_random(), W, H)] + _scene_setups()


@pytest.mark.parametrize("depth_only", [False, True])
def test_block_raster_is_bitwise_the_plain_raster(depth_only):
    for setup, w, h in _cases():
        mine = ref.rasterize(setup, w, h, depth_only=depth_only)
        theirs = port.rasterize_plain(_port_setup(setup), w, h, depth_only=depth_only, full=True)
        for name in ("depth",) if depth_only else ("depth", "tri", "b0", "b1"):
            a, b = getattr(mine, name), getattr(theirs, name)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
        assert int((mine.depth > 0).sum()) > 0


def test_the_sliver_hits_outside_its_corners_only_inside_its_tile():
    setup = _sliver()
    vis = ref.rasterize(setup, W, H)
    ys, xs = torch.nonzero(vis.tri == 0, as_tuple=True)
    assert xs.numel() > 0
    assert int(xs.max()) < ref.TILE_W and int(ys.max()) < ref.TILE_H  # its tile range: tile (0, 0)
    assert bool(((xs.double() + 0.5 > 60.5) | (ys.double() + 0.5 > 30.5)).any())
