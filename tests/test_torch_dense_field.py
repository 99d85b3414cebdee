"""The dense-field deployment (``frame_bench/scenes/dense_field.py``) and
the rasters' parts and counters on it.

On the CPU, at a small size (4 spheres of 8 rings x 16 segments, 256x128,
shadow maps of 256, the small LUTs of ``frame_bench/tests/conftest.py``):

* the frozen scene module's positions, triangles and per-tick
  translations are bitwise the port's ``dense_sphere_field`` moved by
  ``InstanceAnimation.DIAGONAL_WAVE`` (at ``bench.py``'s tessellation too);
* the port's frame, built through the module on the port's API, is
  bitwise the plain reference's (:mod:`frame_bench.reference`) built on
  the reference's API, after 0 and after 5 ticks of the wave: both run
  the same arithmetic on the same moved instances, so no tolerance;
* a recorded frame's counters are the tile lists its binning returned:
  ``raster_overflows`` their overflow flags summed over the launches,
  ``raster_pairs`` their lengths, at the default capacity and at a
  capacity of 1, which makes lists overflow; its parts are the seven
  of ``layers.PARTS``.

The ``cuda``-marked test runs the 1080p field of the benchmark's cell on
the card; it skips without a GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dense_field.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from frame_bench.harness import Inputs, load_cell, port_api, reference_api  # noqa: E402
from frame_bench.scenes import dense_field  # noqa: E402

from syzygy_tpu_torch.renderer.layers import COUNTERS, PARTS, FrameTrace, recording  # noqa: E402

CELL = "dense-field.batch-sunanim"
SMALL_FIELD = dict(rings=8, segments=16, side=2)
SMALL = dict(
    width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64,
    transmittance_width=64, transmittance_height=16,
)
SEED = 2**31 + 23
TICKS = (0, 5)


def _bits(image: torch.Tensor) -> torch.Tensor:
    return image.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def cell():
    cell = load_cell(CELL)
    cell.config = {**cell.config, "render": {**cell.config["render"], **SMALL}}
    return cell


def _frames(api, cell, ticks, field=SMALL_FIELD, device="cpu"):
    """Yield (k, scene, geometry, config) of ``api``'s field at each frame
    number in ``ticks``, moved as the benchmark's loop moves it."""
    scene, library = dense_field.build(api, dense_field.inputs(**field))
    inputs = Inputs(cell.config, cell.traffic, SEED)
    inputs.start(scene)
    config = api.RenderConfig(**cell.config["render"])
    geometry = api.pack_geometry(scene, library, torch.device(device))
    k = 0
    for target in ticks:
        while k < target:
            k += 1
            inputs.step(scene, k)
        yield k, scene, geometry, config


@pytest.mark.parametrize("field", [SMALL_FIELD, dict(rings=32, segments=64, side=8)], ids=["small", "bench"])
def test_frozen_field_is_the_ports_dense_sphere_field(field):
    from syzygy_tpu_torch.scene.scene import InstanceAnimation, dense_sphere_field

    scene, _ = dense_field.build(port_api(), dense_field.inputs(**field))
    ours = scene.geometry[0]
    theirs_scene, _ = dense_sphere_field(**field)
    theirs = theirs_scene.geometry[0]
    theirs.animation = InstanceAnimation.DIAGONAL_WAVE
    assert ours.animation is InstanceAnimation.DIAGONAL_WAVE and len(ours.transforms) == field["side"] ** 2
    for key in ("positions", "normals", "uvs", "colors", "triangles"):
        assert np.array_equal(getattr(ours.mesh, key), getattr(theirs.mesh, key)), key
    assert np.array_equal(ours.scales, theirs.scales)
    # dense_sphere_field leaves its scene ticked once by 0 s
    scene.tick(0.0)
    for dt in (0.0, 1 / 60, 1 / 60, 0.5, 2.0):
        scene.tick(dt)
        theirs_scene.tick(dt)
        assert np.array_equal(ours.translations, theirs.translations)
    assert not np.array_equal(ours.translations, ours.orig_translations)  # the wave moved them


@pytest.fixture(scope="module")
def reference_images(cell):
    from frame_bench.reference.renderer.frame import render_frame

    api = reference_api()
    out = {}
    for k, scene, geometry, config in _frames(api, cell, TICKS):
        params = api.upload_frame_params(api.pack_frame_params(scene, config.width / config.height), "cpu")
        out[k] = render_frame(geometry, params, config)
    return out


def test_port_frame_is_the_plain_reference_bitwise(cell, reference_images):
    api = port_api()
    for k, scene, geometry, config in _frames(api, cell, TICKS):
        host = api.pack_frame_params(scene, config.width / config.height)
        spec = api.frame_param_spec(host)
        image = api.render_frame_packed(geometry, api.flatten_frame_params(host, spec), spec, config)
        assert torch.equal(_bits(image), _bits(reference_images[k])), k


@pytest.mark.parametrize("capacity", [448, 1])
def test_counters_are_the_binnings_lists(cell, monkeypatch, capacity):
    from syzygy_tpu_torch.kernels import raster
    from syzygy_tpu_torch.renderer import frame
    from syzygy_tpu_torch.scene.pack import upload_frame_params

    binned = []

    def spy(*args, **kwargs):
        lists = raster.bin_triangles(*args, **kwargs)
        binned.append(lists)
        return lists

    monkeypatch.setattr(frame, "bin_triangles", spy)
    api = port_api()
    ((_, scene, geometry, config),) = _frames(api, cell, (2,))
    config = dataclasses.replace(config, tile_list_capacity=capacity)
    params = upload_frame_params(api.pack_frame_params(scene, config.width / config.height), "cpu")
    trace = FrameTrace("cpu")
    with recording(trace):
        image = frame.render_frame_eager(geometry, params, config)
    trace.replayed((0.0, 0.0), (0.0, 0.0))
    (replay,) = trace.read()
    assert trace.parts == list(PARTS) and trace.counters == list(COUNTERS)
    assert len(binned) == config.n_shadow_maps + 1  # every shadow slot and the camera
    overflows = sum(int(lists.overflow) for lists in binned)
    assert replay.counters == {
        "raster_overflows": overflows,
        "raster_pairs": sum(int(lists.offsets[-1]) for lists in binned),
    }
    if capacity == 1:
        assert overflows > 0  # 64 slots a tile: the field's camera tiles hold more
    else:
        assert overflows == 0
    assert all(ms >= 0.0 for ms in replay.parts_ms.values())
    layer_ms = replay.layer_ms
    shadow_parts = sum(ms for name, ms in replay.parts_ms.items() if name.startswith("shadow."))
    gbuffer_parts = sum(ms for name, ms in replay.parts_ms.items() if name.startswith("gbuffer."))
    assert shadow_parts <= layer_ms["shadow"] and gbuffer_parts <= layer_ms["gbuffer"]
    monkeypatch.undo()
    assert torch.equal(_bits(image), _bits(frame.render_frame_eager(geometry, params, config)))


# --------------------------------------------------------------------------
# on the card: the benchmark's 1080p field
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the part stamps are captured into a CUDA graph)")
    return torch.device("cuda", 0)


def _event_ms(fn, repeats=5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


@pytest.mark.cuda
def test_dense_replay_parts_fill_shadow_and_gbuffer(cuda, monkeypatch):
    """The cell's field (253,952 triangles) at 1080p with ten 8192^2 maps,
    replayed from its graph: bitwise its eager frame; the parts sum to
    ``shadow`` + ``gbuffer`` less their rest (the maps' zeroing, the
    corner gather, the light-space matrices and the caster mask), which
    is timed alone by CUDA events, within the part stamps' cost (5 us a
    stamp) and a tenth of the rest; ``raster_overflows`` is 0 at capacity
    448 and ``raster_pairs`` the eager frame's lists."""
    from syzygy_tpu_torch.kernels import raster
    from syzygy_tpu_torch.renderer import frame
    from syzygy_tpu_torch.scene.lights import MAX_SPOT_LIGHTS

    cell = load_cell(CELL)
    api = port_api()
    ((_, scene, geometry, config),) = _frames(api, cell, (3,), field={}, device=cuda)
    host = api.pack_frame_params(scene, config.width / config.height)
    spec = api.frame_param_spec(host)
    row = api.flatten_frame_params(host, spec)
    binned = []

    def spy(*args, **kwargs):
        lists = raster.bin_triangles(*args, **kwargs)
        binned.append(lists)
        return lists

    monkeypatch.setattr(frame, "bin_triangles", spy)
    eager = frame.render_frame_eager(geometry, _upload(host, cuda), config)
    pairs = sum(int(lists.offsets[-1]) for lists in binned)
    overflows = sum(int(lists.overflow) for lists in binned)
    monkeypatch.undo()
    frame.render_frame_packed(geometry, row, spec, config)  # the eager frame and the capture
    images = [frame.render_frame_packed(geometry, row, spec, config) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(image, eager) for image in images)
    graph = frame.captured_frames()[-1]
    assert graph["parts"] == list(PARTS) and graph["counters"] == list(COUNTERS)
    part_stamps = graph["nodes"]["part_stamps"]
    assert part_stamps == 3 * config.n_shadow_maps + 1 + 5
    replay = graph["read"]()[-1]
    assert replay.counters == {"raster_overflows": overflows, "raster_pairs": pairs}
    assert overflows == 0, f"{overflows} raster launches overflowed at capacity {config.tile_list_capacity}"
    layers_ms = replay.layer_ms["shadow"] + replay.layer_ms["gbuffer"]
    parts_ms = sum(replay.parts_ms.values())
    dim = config.shadow_dim
    world_h = torch.ones((geometry.positions.shape[0], 4), device=cuda)
    pv = torch.eye(4, device=cuda).expand(2 + MAX_SPOT_LIGHTS, 4, 4).contiguous()

    def rest():
        torch.zeros((2 + MAX_SPOT_LIGHTS, dim, dim), dtype=torch.float32, device=cuda)
        geometry.tri_valid & geometry.tri_casts_shadow
        world_h[geometry.triangles.long()]
        torch.cat([pv[:2] @ pv[:2], pv[2:] @ pv[2:]])

    rest_ms = _event_ms(rest)
    print(f"shadow + gbuffer {layers_ms:.3f} ms, parts {parts_ms:.3f} ms {replay.parts_ms}, "
          f"rest {layers_ms - parts_ms:.3f} ms, timed alone {rest_ms:.3f} ms, {part_stamps} part stamps, "
          f"counters {replay.counters}")
    assert parts_ms <= layers_ms
    assert abs((layers_ms - parts_ms) - rest_ms) <= part_stamps * 0.005 + 0.1 * rest_ms


def _upload(host, device):
    from syzygy_tpu_torch.scene.pack import upload_frame_params

    return upload_frame_params(host, device)
