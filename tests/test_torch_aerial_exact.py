"""The quirk-exact per-pixel aerial integrals as a layer of their own.

On the CPU, on the chess glTF scene of ``frame_bench`` at 128x128 (small
LUTs and shadow maps):

* the port's quirk-exact frame (``aerial_lut=False``) through
  ``render_frame_packed`` and ``render_frame_eager`` is bitwise the plain
  reference's (:mod:`frame_bench.reference`, which computes the integrals
  inside its sky pass): ``fast_sky_reflection`` off and on, ``fast_sky``
  on;
* two ``render_frame_rows`` blocks are bitwise the whole frame (one torch
  thread: multithreaded CPU kernels chunk by tensor size);
* ``sky_camera_pass`` given ``aerial_integrals_exact``'s result is bitwise
  the call that computes the integrals itself;
* a quirk-exact frame's recorder marks ``aerial_exact`` between
  ``skyview_lut`` and ``sky_pass``, a LUT frame's does not;
* ``frame_bench/aerial_work.py`` counts the integrals' pixels, bytes and
  operations as by hand on frames of a few pixels (sky, ground,
  geometry).

This file imports no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from frame_bench.harness import Inputs, load_cell, port_api, scene_module  # noqa: E402

from syzygy_tpu_torch.renderer.layers import FrameTrace, recording  # noqa: E402

CELL = "chess-gltf-quirk-exact.batch-turntable"
SMALL = dict(
    width=128, height=128, shadow_dim=256, skyview_width=128, skyview_height=64,
    transmittance_width=64, transmittance_height=16,
)
SEED, FRAME = 2**31 + 18, 3
MODES = {
    "exact": {},
    "fast_sky_reflection": {"fast_sky_reflection": True},
    "fast_sky": {"fast_sky": True},
}


def _bits(image: torch.Tensor) -> torch.Tensor:
    return image.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def cell():
    cell = load_cell(CELL)
    cell.config = {**cell.config, "render": {**cell.config["render"], **SMALL}}
    return cell


@pytest.fixture(scope="module")
def port(cell):
    """(geometry, host params, spec, flat row, config) of the port's frame
    ``FRAME`` of the cell's turntable."""
    api = port_api()
    module = scene_module(cell.config)
    scene, library = module.build(api, module.inputs())
    inputs = Inputs(cell.config, cell.traffic, SEED)
    inputs.start(scene)
    for k in range(1, FRAME + 1):
        inputs.step(scene, k)
    config = api.RenderConfig(**cell.config["render"])
    host = api.pack_frame_params(scene, config.width / config.height)
    spec = api.frame_param_spec(host)
    geometry = api.pack_geometry(scene, library, torch.device("cpu"))
    return geometry, host, spec, api.flatten_frame_params(host, spec), config


def _params(host):
    from syzygy_tpu_torch.scene.pack import upload_frame_params

    return upload_frame_params(host, "cpu")


@pytest.fixture(scope="module")
def reference_images(cell):
    """The plain reference's frame ``FRAME`` in each mode, rendered once."""
    from frame_bench.check import reference_frames
    from frame_bench.reference.renderer.frame import render_frame

    ((_, geometry, params, config),) = reference_frames(cell, SEED, torch.device("cpu"), [FRAME])
    return {mode: render_frame(geometry, params, dataclasses.replace(config, **o)) for mode, o in MODES.items()}


@pytest.mark.parametrize("entry", ["packed", "eager"])
@pytest.mark.parametrize("mode", list(MODES))
def test_quirk_exact_frame_is_the_plain_reference_bitwise(port, reference_images, mode, entry):
    from syzygy_tpu_torch.renderer.frame import render_frame_eager, render_frame_packed

    geometry, host, spec, row, config = port
    config = dataclasses.replace(config, **MODES[mode])
    assert config.aerial_lut is False
    if entry == "packed":
        image = render_frame_packed(geometry, row, spec, config)
    else:
        image = render_frame_eager(geometry, _params(host), config)
    assert torch.equal(_bits(image), _bits(reference_images[mode]))


def test_row_blocks_are_the_whole_frame_bitwise(port):
    from syzygy_tpu_torch.renderer.frame import render_frame_eager, render_frame_rows

    geometry, host, _, _, config = port
    params = _params(host)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = render_frame_eager(geometry, params, config)
        blocks = [render_frame_rows(geometry, params, config, row0, 64) for row0 in (0, 64)]
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(_bits(torch.cat(blocks)[: config.height]), _bits(whole))


def test_sky_pass_given_the_integrals_is_the_pass_that_takes_them(port, monkeypatch):
    """The frame's own ``sky_camera_pass`` call, made again with
    ``aerial_integrals_exact``'s result of the same inputs and without
    it: bitwise, with and without the metallic bounce."""
    from syzygy_tpu_torch.kernels import sky
    from syzygy_tpu_torch.renderer import frame

    geometry, host, _, _, config = port
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return sky.sky_camera_pass(*args, **kwargs)

    monkeypatch.setattr(frame, "sky_camera_pass", spy)
    frame.render_frame_eager(geometry, _params(host), config)
    ((args, kwargs),) = calls
    assert kwargs["exact"] is not None  # the frame hands the pass its integrals
    lit, depth, gbuffer, camera, atmo, t_lut = args[:6]
    for metallic in (True, False):
        kw = {**kwargs, "metallic_reflection": metallic, "exact": None}
        exact = sky.aerial_integrals_exact(
            depth, gbuffer, camera, atmo, t_lut, kw["draw_extent"], metallic, kw["row_origin"],
            fast=kw["fast"], fast_reflection=kw["fast_reflection"],
        )
        assert (exact.bounce is not None) == metallic
        given = sky.sky_camera_pass(*args, **{**kw, "exact": exact})
        assert torch.equal(_bits(given), _bits(sky.sky_camera_pass(*args, **kw)))


@pytest.mark.parametrize("aerial_lut", [False, True], ids=["quirk_exact", "aerial_lut"])
def test_recorder_marks_aerial_exact_only_in_a_quirk_exact_frame(port, aerial_lut):
    from syzygy_tpu_torch.renderer.frame import render_frame_eager

    geometry, host, _, _, config = port
    trace = FrameTrace("cpu")
    with recording(trace):
        render_frame_eager(geometry, _params(host), dataclasses.replace(config, aerial_lut=aerial_lut))
    sky_layers = ["skyview_lut", "aerial_lut", "sky_pass"] if aerial_lut else ["skyview_lut", "aerial_exact", "sky_pass"]
    assert trace.layers == ["state", "shadow", "gbuffer", "lighting", *sky_layers, "encode"]


# --------------------------------------------------------------------------
# frame_bench/aerial_work.py: the least work of the integrals
# --------------------------------------------------------------------------

R = 6.36  # the planet's radius, Mm


def _rays(directions):
    """A 1 x n frame of rays from 1 km above the ground, +y up."""
    position = torch.tensor([0.0, R + 0.001, 0.0])
    direction = torch.tensor(directions, dtype=torch.float32)[None]
    return position, direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)


@pytest.mark.parametrize(
    "depth, directions, counted",
    [
        ([0.0, 0.0], [[0.0, 1.0, 0.0], [0.3, 0.2, 0.0]], 0),  # sky: both rays miss the planet
        ([0.0, 0.0], [[0.0, -1.0, 0.0], [0.3, 0.2, 0.0]], 1),  # ground: one ray meets the planet
        ([0.5, 0.25], [[0.0, 1.0, 0.0], [0.3, 0.2, 0.0]], 2),  # geometry on rays into the sky
    ],
    ids=["sky", "ground", "geometry"],
)
def test_aerial_work_counts_by_hand(depth, directions, counted):
    from frame_bench.aerial_work import counted_pixels, work_of
    from frame_bench.roofline import PEAK_BYTES_PER_S, PEAK_F32_FLOPS

    position, direction = _rays(directions)
    n = counted_pixels(torch.tensor([depth]), position, direction, torch.tensor(R))
    assert n == counted
    work = work_of(n)
    assert work.bytes == counted * (12 + 12)  # the surface position read, the integral written
    assert work.ops == counted * 32 * 454
    assert work.least_s == max(counted * 24 / PEAK_BYTES_PER_S, counted * 32 * 454 / PEAK_F32_FLOPS)


def test_aerial_work_step_count_adds_up():
    """The step's terms, each derived in the module's docstring, and U,
    one transmittance-LUT sample: 24 for (r, mu) -> uv, 41 bilinear."""
    from frame_bench.aerial_work import OPS_PER_STEP, SHARED_RADIUS, STEP_TERMS, U

    assert U == 65 and SHARED_RADIUS == 16
    assert len(STEP_TERMS) == 13 and OPS_PER_STEP == sum(STEP_TERMS.values()) == 454
    assert STEP_TERMS["t_path = sample_transmittance_segment: direction 13, flip 5, two ray samples 35 "
                      "and 2 U, ratio 12"] == 13 + 5 + 35 + 2 * U + 12
