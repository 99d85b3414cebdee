"""The whole frame and its per-pixel passes vs the reference (f).

Frame: the port's ``render_frame`` (its own host packing) vs the
reference's ``render_frame`` at the golden config: RMSE <= 1e-3 and max
abs <= 2e-2 (the reference's parity budget and its fast-mode max bound);
vs ``tests/goldens/default_scene_256x128.png`` read with the port's
stdlib reader: RMSE < 5e-3 (``tests/test_golden.py:50``).
Passes: the resolve, the lighting and the sky camera pass fed the
reference's own intermediates (visibility buffer, records, G-buffer,
shadow maps, LUTs).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    port_config,
    port_golden_scene,
    reference_golden_scene,
    reference_inputs,
    rmse,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "default_scene_256x128.png")
FRAME_RMSE = 1e-3
FRAME_MAX = 2e-2


@functools.lru_cache(maxsize=None)
def reference_frame(render_atmosphere: bool = True) -> np.ndarray:
    from syzygy_tpu.renderer import render_frame
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    scene, lib, config = reference_golden_scene()
    config = dataclasses.replace(config, render_atmosphere=render_atmosphere)
    scene.render_atmosphere = render_atmosphere
    return np.asarray(render_frame(pack_geometry(scene, lib), pack_frame_params(scene, 2.0), config))


@functools.lru_cache(maxsize=None)
def port_frame(render_atmosphere: bool = True) -> np.ndarray:
    from syzygy_tpu_torch.renderer.frame import render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    scene, lib, config = port_golden_scene()
    config = dataclasses.replace(config, render_atmosphere=render_atmosphere)
    scene.render_atmosphere = render_atmosphere
    geometry = pack_geometry(scene, lib, "cpu")
    params = upload_frame_params(pack_frame_params(scene, 2.0), "cpu")
    return render_frame(geometry, params, config).numpy()


@pytest.mark.parametrize("render_atmosphere", [True, False])
def test_frame_matches_reference(render_atmosphere):
    port, ref = port_frame(render_atmosphere), reference_frame(render_atmosphere)
    assert port.shape == ref.shape == (128, 256, 3)
    assert np.isfinite(port).all()
    assert rmse(port, ref) <= FRAME_RMSE
    assert np.abs(port - ref).max() <= FRAME_MAX


def test_frame_matches_golden():
    from syzygy_tpu_torch.utils.png import read_png

    golden = read_png(GOLDEN)[..., :3].astype(np.float32) / 255.0
    assert rmse(port_frame(), golden) < 5e-3


@functools.lru_cache(maxsize=None)
def reference_stages():
    """The reference's geometry stage (state, visibility, records, shadow
    maps) at the golden config, plus its G-buffer and clamped lighting."""
    from syzygy_tpu.kernels.lighting import deferred_lighting
    from syzygy_tpu.kernels.resolve import resolve_gbuffer_from_records
    from syzygy_tpu.renderer.frame import _stage_geometry

    geometry, params, geo_t, params_t, config = reference_inputs("default")
    state, vis, records, maps = _stage_geometry(geometry, params, config)
    gbuffer = jax.jit(resolve_gbuffer_from_records)(vis, records, geometry)

    @jax.jit
    def lighting(gbuffer, state, maps):
        return jnp.clip(
            deferred_lighting(
                gbuffer, state.camera, state.directional_lights, state.directional_count,
                state.directional_skip_count, state.spot_lights, state.spot_count, maps,
                pcf_f16=config.pcf_f16, shadowless_eps=config.shadowless_strength_eps,
            ),
            0.0,
            1.0,
        )

    lit = lighting(gbuffer, state, maps)
    return state, vis, records, maps, gbuffer, lit, geo_t, params_t, config


def _t(x):
    return torch.from_numpy(np.array(x))


def test_records_match_reference():
    """build_resolve_records on the same setup and vertices: exact."""
    from syzygy_tpu_torch.kernels.raster import setup_triangles
    from syzygy_tpu_torch.kernels.resolve import build_resolve_records, transform_normals, transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    _, _, records, _, _, _, geo_t, params_t, config = reference_stages()
    state = prepare_frame_state(params_t)
    clip, world = transform_positions(
        geo_t.positions, geo_t.vert_instance, state.models, matmul4(state.camera.projection, state.camera.view)
    )
    normals = transform_normals(geo_t.normals, geo_t.vert_instance, state.model_inv_transpose)
    setup = setup_triangles(
        clip, geo_t.triangles, geo_t.tri_valid, config.width, config.height, 1,
        grid_width=config.padded_width, grid_height=config.padded_height,
    )
    np.testing.assert_array_equal(build_resolve_records(setup, geo_t, world, normals).numpy(), np.asarray(records))


def test_resolve_matches_reference():
    """G-buffer from the reference's visibility buffer + records: 1e-5,
    world positions 1e-6 of the frame's position scale (an f32
    interpolation across corners kilometres apart cancels there)."""
    from syzygy_tpu_torch.kernels.raster import VisibilityBuffer
    from syzygy_tpu_torch.kernels.resolve import resolve_gbuffer_from_records

    _, vis, records, _, gbuffer, _, geo_t, _, _ = reference_stages()
    port = resolve_gbuffer_from_records(VisibilityBuffer(*[_t(x) for x in vis]), _t(records), geo_t)
    for name in port._fields:
        ref = np.asarray(getattr(gbuffer, name))
        atol = 1e-6 * np.abs(ref).max() if name == "world_position" else 1e-5
        np.testing.assert_allclose(getattr(port, name).numpy(), ref, atol=atol, rtol=0, err_msg=name)


def test_lighting_matches_reference():
    """deferred_lighting (clamped) from the reference's G-buffer and shadow
    maps, f16 PCF, relative shadowless gate: 1e-5."""
    from syzygy_tpu_torch.kernels.lighting import deferred_lighting
    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    _, _, _, maps, gbuffer, lit, _, params_t, config = reference_stages()
    state = prepare_frame_state(params_t)
    port = deferred_lighting(
        GBuffer(*[_t(x) for x in gbuffer]), state.camera, state.directional_lights,
        state.directional_count, state.directional_skip_count, state.spot_lights, state.spot_count,
        _t(maps), pcf_f16=config.pcf_f16, shadowless_eps=config.shadowless_strength_eps,
    )
    np.testing.assert_allclose(torch.clamp(port, 0, 1).numpy(), np.asarray(lit), atol=1e-5, rtol=0)


def test_sky_camera_pass_matches_reference():
    """sky_camera_pass from the reference's lit color, depth, G-buffer,
    LUTs and sun map (metallic bounce on, as the golden config): 1e-4."""
    from syzygy_tpu.kernels.atmosphere import (
        compute_skyview_lut,
        compute_transmittance_lut,
        pack_lut,
        pack_lut_q8,
    )
    from syzygy_tpu.kernels.sky import build_aerial_lut, compute_skyview_tseg, pack_tseg_rows, sky_camera_pass

    from syzygy_tpu_torch.kernels.atmosphere import LUTQ8
    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.kernels.sky import AerialLUT
    from syzygy_tpu_torch.kernels.sky import sky_camera_pass as port_pass
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    state, vis, _, maps, gbuffer, lit, _, params_t, config = reference_stages()
    atmo, cam = state.atmosphere, state.camera
    t_lut = compute_transmittance_lut(atmo)
    origin = cam.position[:3] / 1e6 * jnp.array([1.0, -1.0, 1.0]) + jnp.array([0.0, atmo.planet_radius_mm, 0.0])
    sky = compute_skyview_lut(atmo, origin, pack_lut(t_lut), width=128, height=64)
    q8 = pack_lut_q8(sky)
    tseg = pack_tseg_rows(compute_skyview_tseg(atmo, pack_lut(t_lut), origin, 64))
    aerial = build_aerial_lut(atmo, pack_lut(t_lut), cam, origin, 4000 / 1e6)
    sun = jax.tree.map(lambda x: x[0], state.directional_lights)
    ref = sky_camera_pass(
        lit, vis.depth, gbuffer, cam, atmo, pack_lut(t_lut), q8, sun, maps[0],
        draw_extent=(256, 128), metallic_reflection=True, aerial=aerial,
        aerial_t_max=4000 / 1e6, tseg_rows=tseg, pcf_f16=True,
    )

    words = np.asarray(q8.words)
    codes = np.stack([(words[:, j] >> (8 * b)) & 255 for j in range(3) for b in range(4)], -1)
    port_q8 = LUTQ8(
        torch.from_numpy(codes.astype(np.uint8).reshape(64, 128, 12)),
        torch.from_numpy(words[:, 3].view(np.float32).reshape(64, 128).copy()),
    )
    volume = np.asarray(aerial.packed).reshape(32, 32, 16, 72)[..., :9]
    pstate = prepare_frame_state(params_t)
    port = port_pass(
        _t(lit), _t(vis.depth), GBuffer(*[_t(x) for x in gbuffer]), pstate.camera,
        pstate.atmosphere, _t(t_lut), port_q8,
        type(pstate.directional_lights)(*[x[0] for x in pstate.directional_lights]), _t(maps[0]),
        (256, 128), AerialLUT(_t(volume), _t(aerial.t_sun0)), 4000 / 1e6, _t(tseg),
        metallic_reflection=True, pcf_f16=True,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_port_config_carries_reference_values():
    """The golden config crosses over field by field."""
    *_, config = reference_inputs("default")
    cfg = port_config(config)
    assert (cfg.width, cfg.height, cfg.shadow_dim, cfg.skyview_width) == (256, 128, 256, 128)
    assert cfg.padded_width == config.padded_width and cfg.padded_height == config.padded_height


def test_app_writes_frames(tmp_path):
    """``python -m syzygy_tpu_torch.app`` on the CPU: one PNG per frame, the
    sun advancing between frames."""
    from syzygy_tpu_torch.app.__main__ import main
    from syzygy_tpu_torch.utils.png import read_png

    main([
        "--frames", "2", "--width", "64", "--height", "32", "--shadow-dim", "128",
        "--skyview-scale", "16", "--dt", "600", "--out", str(tmp_path), "--device", "cpu",
    ])
    frames = [read_png(str(tmp_path / f"frame_{i:04d}.png")) for i in range(2)]
    assert all(f.shape == (32, 64, 4) for f in frames)
    assert not np.array_equal(frames[0], frames[1])
