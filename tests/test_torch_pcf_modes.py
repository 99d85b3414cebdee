"""The PCF modes of ``sample_shadow_map`` and the shared sun PCF vs the
reference, on seeded maps and coords (shaped as ``tests/test_lighting.py``
shapes them).

* The size gate: above 2048 texels the reference's taps read the f32 map
  whatever the storage flags say (``lighting.py:191-192``): bitwise at
  2048 and 4096 texels with f16 off and on and with q8.
* The gather layouts ``bitmask``, ``window2d`` and ``seg8``: bitwise.
* ``q8``: bitwise the reference's op-by-op value; against its compiled
  value the occluded-tap counts differ on at most 0.1% of pixels, by at
  most one tap, and the factors otherwise by one rounding at the scale
  of 1 (2^-24). An all-zero map gives exactly 1.0.
* ``sun_shadow`` given to ``deferred_lighting`` and ``sky_camera_pass``
  as the sun's own PCF: bitwise the call without it.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import reference_compiled_and_op_by_op
from test_torch_flagship import port_flagship

def pcf_inputs(seed: int, size: int, h: int, w: int, margin: float, zero_map: bool = False):
    """A seeded (size, size) map in [0, 1) (or all zeros) and (h, w)
    coords whose u, v reach ``margin`` outside the map, as numpy."""
    rng = np.random.default_rng(seed)
    smap = np.zeros((size, size), np.float32) if zero_map else rng.random((size, size), np.float32)
    coord = np.stack(
        [
            rng.uniform(-margin, 1.0 + margin, (h, w)),
            rng.uniform(-margin, 1.0 + margin, (h, w)),
            rng.random((h, w)),  # receiver depth
            np.ones((h, w)),
        ],
        axis=-1,
    ).astype(np.float32)
    dx = rng.random((h, w), np.float32)
    dy = rng.random((h, w), np.float32)
    return smap, coord, dx, dy


def reference_pcf(inputs, **flags) -> np.ndarray:
    """The reference's ``sample_shadow_map``, op by op."""
    from syzygy_tpu.kernels.lighting import sample_shadow_map

    return np.asarray(sample_shadow_map(*[jnp.asarray(a) for a in inputs], **flags))


def port_pcf(inputs, **flags) -> np.ndarray:
    from syzygy_tpu_torch.kernels.lighting import sample_shadow_map

    return sample_shadow_map(*[torch.from_numpy(a) for a in inputs], **flags).numpy()


@pytest.mark.parametrize("size", [2048, 4096])
@pytest.mark.parametrize("flags", [{}, {"f16": True}, {"q8": True}], ids=["f32", "f16", "q8"])
def test_size_gate_matches_reference(size, flags):
    """At 4096 texels the reference ignores the storage flags and reads
    the f32 map; at 2048 they apply. Bitwise either way."""
    inputs = pcf_inputs(23, size, 64, 128, 0.05)
    ref = reference_pcf(inputs, **flags)
    out = port_pcf(inputs, **flags)
    print(f"{size} {flags}: {int((out != ref).sum())} of {ref.size} pixels differ")
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("layout", ["bitmask", "window2d", "seg8"])
def test_gather_layouts_match_reference(size, layout):
    """The reference's gather layouts give its default taps; the port
    takes its one direct form for them. Bitwise, f32 and f16 storage."""
    inputs = pcf_inputs(17, size, 33, 65, 0.3)
    for f16 in (False, True):
        np.testing.assert_array_equal(
            port_pcf(inputs, f16=f16, **{layout: True}), reference_pcf(inputs, f16=f16, **{layout: True})
        )


def occluded_taps(factor) -> np.ndarray:
    """The count of occluded taps behind a light factor 1 - n / 25."""
    return np.rint((1.0 - factor.astype(np.float64)) * 25.0).astype(np.int64)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("zero_map", [False, True], ids=["random", "zero"])
def test_q8_matches_reference(size, zero_map):
    """u8 block-scaled segments: bitwise the reference's op-by-op value.
    Its compiled value divides the tap count by 25 as a multiply by the
    reciprocal, 2^-24 away on many pixels; there the tap counts may
    differ on at most 0.1% of pixels, by at most one tap, and the factors
    otherwise by that rounding alone."""
    from syzygy_tpu.kernels.lighting import sample_shadow_map

    inputs = pcf_inputs(11, size, 48, 96, 0.2, zero_map)
    compiled, op_by_op = reference_compiled_and_op_by_op(
        functools.partial(sample_shadow_map, q8=True), *[jnp.asarray(a) for a in inputs]
    )
    out = port_pcf(inputs, q8=True, f16=True)  # q8 takes precedence over f16
    np.testing.assert_array_equal(out, op_by_op)
    taps, compiled_taps = occluded_taps(out), occluded_taps(compiled)
    flips = taps != compiled_taps
    print(
        f"q8 {size} zero_map={zero_map}: {int((out != compiled).sum())} of {out.size} factors differ from "
        f"the compiled value, {int(flips.sum())} tap counts"
    )
    assert flips.sum() <= 1e-3 * out.size
    assert np.abs(taps - compiled_taps).max() <= 1
    assert np.abs(out - compiled)[~flips].max(initial=0.0) <= 2.0**-24  # one rounding at the scale of 1
    if zero_map:
        np.testing.assert_array_equal(out, np.ones_like(out))


@functools.lru_cache(maxsize=None)
def port_stages():
    """The port's geometry stage of the chess flagship at 128x64 on the
    CPU (its sun casts shadows; the golden scene's sun map is empty):
    (state, vis, gbuffer, shadow maps, light activity, config)."""
    from syzygy_tpu_torch.kernels.lighting import light_activity
    from syzygy_tpu_torch.renderer.frame import RenderConfig, _geometry
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    scene, lib = port_flagship()
    config = RenderConfig(width=128, height=64, shadow_dim=256, skyview_width=128, skyview_height=64)
    geometry = pack_geometry(scene, lib, "cpu")
    params = upload_frame_params(pack_frame_params(scene, config.width / config.height), "cpu")
    state, vis, gbuffer, maps, _ = _geometry(geometry, params, config, 0, config.padded_height)
    activity = light_activity(
        state.directional_lights, state.directional_count, state.directional_skip_count,
        state.spot_lights, state.spot_count, config.shadowless_strength_eps, config.n_shadow_maps,
    )
    return state, vis, gbuffer, maps, activity, config


def sun_pcf(state, gbuffer, maps, **flags):
    from syzygy_tpu_torch.kernels.lighting import compute_shadow_frame, convert_pbr, sample_shadow_map
    from syzygy_tpu_torch.math.geometry import matmul4

    material = convert_pbr(gbuffer)
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    coord, dx, dy = compute_shadow_frame(matmul4(sun.projection, sun.view), material.position, material.normal)
    return sample_shadow_map(maps[0], coord, dx, dy, **flags)


@pytest.mark.parametrize("flags", [{"f16": True}, {"q8": True}], ids=["f16", "q8"])
def test_flagship_sun_pcf_matches_reference(flags):
    """A real map: the flagship's sun map and the shadow frame of its
    G-buffer (piecewise-smooth depths, silhouettes, self-shadowing),
    bitwise the reference's op-by-op PCF."""
    from syzygy_tpu_torch.kernels.lighting import compute_shadow_frame, convert_pbr
    from syzygy_tpu_torch.math.geometry import matmul4

    state, _, gbuffer, maps, _, _ = port_stages()
    material = convert_pbr(gbuffer)
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    coord, dx, dy = compute_shadow_frame(matmul4(sun.projection, sun.view), material.position, material.normal)
    inputs = tuple(x.numpy() for x in (maps[0], coord, dx, dy))
    out = port_pcf(inputs, **flags)
    assert (out < 1.0).sum() > 100  # the sun's shadow falls on the board
    np.testing.assert_array_equal(out, reference_pcf(inputs, **flags))


@pytest.mark.parametrize("q8", [False, True], ids=["f16", "q8"])
def test_lighting_sun_shadow_replaces_the_sun_pcf(q8):
    from syzygy_tpu_torch.kernels.lighting import deferred_lighting

    from syzygy_tpu_torch.kernels.lighting import light_activity

    state, _, gbuffer, maps, _, config = port_stages()
    # the sky pass lights with the sun (directional_skip_count 1); count
    # it in the lighting here, as the frame without the atmosphere does
    skip = torch.tensor(0, dtype=torch.int32)
    activity = light_activity(
        state.directional_lights, state.directional_count, skip,
        state.spot_lights, state.spot_count, config.shadowless_strength_eps, config.n_shadow_maps,
    )
    assert bool(activity.shadowed_dirs[0])
    args = (
        gbuffer, state.camera, state.directional_lights, state.directional_count, skip, state.spot_lights,
        state.spot_count, maps,
    )
    flags = dict(pcf_f16=True, pcf_q8=q8, shadowless_eps=config.shadowless_strength_eps)
    plain = deferred_lighting(*args, **flags)
    shared = deferred_lighting(*args, **flags, sun_shadow=sun_pcf(state, gbuffer, maps, f16=True, q8=q8))
    assert torch.equal(shared, plain)
    assert shared.abs().sum() > 0
    # the buffer is what the sun reads: a fully lit sun moves the frame
    unshadowed = deferred_lighting(*args, **flags, sun_shadow=torch.ones(gbuffer.diffuse.shape[:2]))
    assert not torch.equal(unshadowed, plain)


@pytest.mark.parametrize("q8", [False, True], ids=["f16", "q8"])
def test_sky_sun_shadow_replaces_the_sun_pcf(q8):
    from syzygy_tpu_torch.kernels.atmosphere import (
        METERS_PER_MM,
        compute_skyview_lut,
        compute_transmittance_lut,
        pack_lut_q8,
    )
    from syzygy_tpu_torch.kernels.sky import build_aerial_lut, sky_camera_pass

    state, vis, gbuffer, maps, _, config = port_stages()
    atmo, cam = state.atmosphere, state.camera
    t_lut = compute_transmittance_lut(atmo, config.transmittance_width, config.transmittance_height)
    origin = cam.position[:3] / METERS_PER_MM * torch.tensor([1.0, -1.0, 1.0]) + torch.stack(
        [torch.zeros(()), atmo.planet_radius_mm, torch.zeros(())]
    )
    sky = pack_lut_q8(compute_skyview_lut(atmo, origin, t_lut, config.skyview_width, config.skyview_height))
    aerial = build_aerial_lut(atmo, t_lut, cam, origin, 4000.0 / METERS_PER_MM)
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    lit = torch.zeros_like(gbuffer.diffuse[..., :3])

    def run(sun_shadow):
        return sky_camera_pass(
            lit, vis.depth, gbuffer, cam, atmo, t_lut, sky, sun, maps[0],
            (config.width, config.height), aerial, 4000.0 / METERS_PER_MM,
            pcf_f16=True, pcf_q8=q8, sun_shadow=sun_shadow,
        )

    plain = run(None)
    assert torch.equal(run(sun_pcf(state, gbuffer, maps, f16=True, q8=q8)), plain)
    assert not torch.equal(run(torch.zeros_like(vis.depth)), plain)
