"""The raster roofline's count: from the scene and the targets, the same
whatever raster implements it, and a box that holds every hit."""

import dataclasses

import torch
from conftest import CELLS, SEED, small_cell

from frame_bench.check import reference_frames
from frame_bench.reference.kernels.raster import _setup_slots, rasterize, setup_triangles
from frame_bench.reference.kernels.resolve import transform_positions
from frame_bench.reference.math.geometry import matmul4
from frame_bench.reference.scene.pack import prepare_frame_state
from frame_bench.roofline import CAMERA_BYTES_PER_PIXEL, OPS_PER_PIXEL, raster_work

CPU = torch.device("cpu")


def _frame(name, k=2, **render):
    cell = small_cell(name, **render)
    return next(reference_frames(cell, SEED, CPU, [k]))[1:]


def test_count_is_the_same_with_tile_lists_and_by_full_iteration():
    for name in CELLS:
        listed = raster_work(*_frame(name, tile_list_capacity=448))
        full = raster_work(*_frame(name, tile_list_capacity=0))
        assert listed == full
        geometry, params, config = _frame(name)
        assert raster_work(geometry, params, dataclasses.replace(config, tile_list_capacity=0)) == listed
        assert listed.ops > 0 and listed.bytes > config.width * config.height * CAMERA_BYTES_PER_PIXEL


def test_every_camera_hit_lies_in_its_counted_box():
    geometry, params, config = _frame(CELLS[1])
    state = prepare_frame_state(params)
    clip, _ = transform_positions(
        geometry.positions, geometry.vert_instance, state.models,
        matmul4(state.camera.projection, state.camera.view),
    )
    w, h = config.render_width, config.render_height
    cols, _, _ = _setup_slots(clip[geometry.triangles.long()], geometry.tri_valid, w, h, +1)
    setup = setup_triangles(clip, geometry.triangles, geometry.tri_valid, w, h, cull_keep_sign=+1,
                            grid_width=config.padded_width, grid_height=config.padded_height)
    vis = rasterize(setup, config.padded_width, config.padded_height)
    ys, xs = torch.nonzero(vis.tri[:h, :w] >= 0, as_tuple=True)
    slots = vis.tri[ys, xs].long()
    assert slots.numel() > 1000
    c = cols[slots]
    assert bool((c[:, 9] > 0).all())
    px, py = xs.double() + 0.5, ys.double() + 0.5
    assert bool(((c[:, 10] <= px) & (px <= c[:, 11]) & (c[:, 12] <= py) & (py <= c[:, 13])).all())
    # every hit is an operation the count holds
    camera_ops = raster_work(geometry, params, config).ops
    assert camera_ops >= OPS_PER_PIXEL * slots.numel()
