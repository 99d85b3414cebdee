"""The quirk-exact sky (``RenderConfig.aerial_lut=False``) and ``fast_sky``
of the port vs the JAX package.

* ``luminance_scattering_integral_fast`` and ``compute_skyview_lut`` with
  ``rowwise=False`` and with ``fast=True``: the LUT class (2e-5 absolute /
  2e-4 relative) at 64x32;
* ``sample_skyview``, ``sample_skyview_ground``, ``sample_sun_disk``,
  ``sample_ground`` and ``sample_environment`` on seeded rays: the LUT
  class;
* ``sky_camera_pass`` with ``aerial=None`` fed the reference's own lit
  color, depth, G-buffer, LUTs and sun map of the chess flagship at
  256x144, at the flagship's own low sun and at a daylight sun, each of
  ``fast``, ``fast_reflection`` and ``metallic_reflection`` on and off:
  on every pixel row 1e-5 relative beyond the reference's own f32 spread
  in that row, which the test computes (its compiled value against its
  op-by-op value: see ``own_spread_rows``), and on the sky's pixels 1e-5
  relative of the op-by-op value;
* whole frames vs ``syzygy_tpu.renderer.render_frame`` at the same config
  (quirk-exact, ``fast_sky``): the frame class, RMSE <= 1e-3.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    assert_rows_within_own_spread,
    own_spread_rows,
    port_config,
    port_q8,
    reference_compiled_and_op_by_op,
    rmse,
    to_numpy_dict,
)
from test_torch_flagship import reference_flagship

PASS_W, PASS_H = 256, 144
LUT_ATOL, LUT_RTOL = 2e-5, 2e-4  # ROADMAP's LUT class


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def atmosphere_inputs():
    """(reference atmosphere, port atmosphere, reference t_lut, origin) of
    the default scene at sun time 0.35."""
    from syzygy_tpu.kernels.atmosphere import compute_transmittance_lut
    from syzygy_tpu.scene.atmosphere import atmosphere_raw, pack_atmosphere
    from syzygy_tpu.scene import default_scene

    from syzygy_tpu_torch.scene.atmosphere import AtmosphereRaw
    from syzygy_tpu_torch.scene.atmosphere import pack_atmosphere as port_pack

    scene, _ = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    raw = atmosphere_raw(scene.atmosphere)
    atmo = pack_atmosphere(raw)
    port_atmo = port_pack(AtmosphereRaw(*[t(np.asarray(x)) for x in raw]))
    t_lut = np.asarray(compute_transmittance_lut(atmo, width=128, height=32))
    origin = np.array([18.0e-6, float(atmo.planet_radius_mm) + 16.0e-6, -22.0e-6], np.float32)
    return atmo, port_atmo, t_lut, origin


def test_fast_integral_matches_reference():
    """``luminance_scattering_integral_fast`` on seeded rays from the
    camera's origin (upward, grazing and ground-hitting): LUT class."""
    from syzygy_tpu.kernels.atmosphere import luminance_scattering_integral_fast, raycast_atmosphere

    from syzygy_tpu_torch.kernels import atmosphere as port

    atmo, port_atmo, t_lut, origin = atmosphere_inputs()
    rng = np.random.default_rng(11)
    direction = rng.normal(size=(24, 32, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    o = np.broadcast_to(origin, direction.shape).copy()
    dist = np.asarray(raycast_atmosphere(atmo, jnp.asarray(o), jnp.asarray(direction)))
    ref = np.asarray(
        jax.jit(luminance_scattering_integral_fast)(atmo, jnp.asarray(t_lut), jnp.asarray(o), jnp.asarray(direction), jnp.asarray(dist))
    )
    out = port.luminance_scattering_integral_fast(port_atmo, t(t_lut), t(o), t(direction), t(dist)).numpy()
    assert np.isfinite(out).all() and ref.max() > 1e-3
    np.testing.assert_allclose(out, ref, atol=LUT_ATOL, rtol=LUT_RTOL)


@pytest.mark.parametrize("fast,rowwise", [(False, False), (True, True), (True, False)], ids=["texel", "fast", "fast_texel"])
def test_skyview_lut_per_texel_matches_reference(fast, rowwise):
    """``compute_skyview_lut(fast=, rowwise=)`` at 64x32: LUT class."""
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut

    from syzygy_tpu_torch.kernels.atmosphere import compute_skyview_lut as port_lut

    atmo, port_atmo, t_lut, origin = atmosphere_inputs()

    def reference():
        return np.asarray(
            compute_skyview_lut(atmo, jnp.asarray(origin), jnp.asarray(t_lut), width=64, height=32, fast=fast, rowwise=rowwise)
        )

    ref = reference()
    out = port_lut(port_atmo, t(origin), t(t_lut), 64, 32, fast=fast, rowwise=rowwise).numpy()
    assert out.shape == (32, 64, 3)
    if fast:
        np.testing.assert_allclose(out, ref, atol=LUT_ATOL, rtol=LUT_RTOL)
        return
    # the LUT-ratio integral from an origin 16 m above the ground: the rows
    # next to the horizon (v = 0.5) hold grazing rays, where the reference's
    # compiled value leaves its own op-by-op value by up to 6e-4. Each row
    # is held to the LUT class beyond the reference's own spread there.
    with jax.disable_jit():
        spread = own_spread_rows(ref, reference())
    away = spread <= LUT_ATOL
    assert away.sum() >= 29  # the spread exceeds the class on the horizon rows only
    np.testing.assert_allclose(out[away], ref[away], atol=LUT_ATOL, rtol=LUT_RTOL)
    assert_rows_within_own_spread(out, ref, spread, np.full(32, LUT_ATOL, np.float32), "per-texel sky-view LUT")


def test_skyview_lut_defaults_are_the_reference_s():
    """``fast=False, rowwise=True`` by default, as in the reference."""
    import inspect

    from syzygy_tpu_torch.kernels.atmosphere import compute_skyview_lut

    sig = inspect.signature(compute_skyview_lut)
    assert sig.parameters["fast"].default is False
    assert sig.parameters["rowwise"].default is True


@pytest.mark.parametrize(
    "name", ["sample_skyview", "sample_skyview_ground", "sample_sun_disk", "sample_ground", "sample_environment"]
)
def test_environment_functions_match_reference(name):
    """The unshared environment functions on seeded rays from the camera
    (none within 6 degrees of the horizon; half of them towards the sun for
    the disk): 2e-5 absolute / 2e-4 relative (the ground and the
    environment hold a 32-step integral: the LUT class). The sun disk's
    edge is a smoothstep of ``sqrt(1 - cos^2)`` at ``cos`` within 1e-5 of
    1: an ulp of the dot product moves it by up to 5e-3, its tolerance."""
    from syzygy_tpu.kernels import sky as reference
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut

    from syzygy_tpu_torch.kernels import sky as port

    atmo, port_atmo, t_lut, origin = atmosphere_inputs()
    sky_lut = np.asarray(compute_skyview_lut(atmo, jnp.asarray(origin), jnp.asarray(t_lut), width=64, height=32))
    rng = np.random.default_rng(17)
    n = 2048
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    to_sun = -np.asarray(atmo.incident_direction_sun)
    direction[: n // 2] = to_sun + 0.02 * direction[: n // 2]
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction[np.abs(direction[:, 1]) > 0.1]
    if name == "sample_ground":
        direction = direction[direction[:, 1] < 0]
    o = np.broadcast_to(origin, direction.shape).copy()
    jo, jd, jt, js = jnp.asarray(o), jnp.asarray(direction), jnp.asarray(t_lut), jnp.asarray(sky_lut)
    po, pd, pt, ps = t(o), t(direction), t(t_lut), t(sky_lut)
    if name in ("sample_skyview", "sample_skyview_ground"):
        ref = getattr(reference, name)(atmo, js, jo, jd)
        out = getattr(port, name)(port_atmo, ps, po, pd)
    elif name == "sample_sun_disk":
        ref = reference.sample_sun_disk(atmo, jt, jo, jd)
        out = port.sample_sun_disk(port_atmo, pt, po, pd)
        assert float(np.asarray(ref).max()) > 0.1  # some rays see the disk
    elif name == "sample_ground":
        _, dist = reference._hit_planet(atmo, jo, jd)
        ref = jax.jit(reference.sample_ground)(atmo, jt, jo, jd, dist)
        out = port.sample_ground(port_atmo, pt, po, pd, t(dist))
    else:
        ref_env, ref_disk = jax.jit(reference.sample_environment)(atmo, jt, js, jo, jd)
        ref = ref_env
        out, disk = port.sample_environment(port_atmo, pt, ps, po, pd)
        np.testing.assert_allclose(disk.numpy(), np.asarray(ref_disk), atol=5e-3, rtol=0)
    atol = 5e-3 if name == "sample_sun_disk" else LUT_ATOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=LUT_RTOL)


# --------------------------------------------------------------------------
# the pass on the reference's own inputs
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pass_inputs(sun_time):
    """The reference's geometry stage, lit color and LUTs of the chess
    flagship at 256x144 (``sun_time`` None: the flagship's own low sun)."""
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut, compute_transmittance_lut, pack_lut_q8
    from syzygy_tpu.kernels.lighting import deferred_lighting
    from syzygy_tpu.kernels.resolve import resolve_gbuffer_from_records
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.renderer.frame import _stage_geometry
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    from syzygy_tpu_torch.interop import from_reference
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    scene, lib = reference_flagship()
    saved = scene.sun_animation.time
    if sun_time is not None:
        scene.sun_animation.time = sun_time
        scene.tick(0.0)
    config = RenderConfig(width=PASS_W, height=PASS_H, shadow_dim=256, skyview_width=128, skyview_height=64)
    geometry = pack_geometry(scene, lib, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, PASS_W / PASS_H)
    if sun_time is not None:
        scene.sun_animation.time = saved
        scene.tick(0.0)
    state, vis, records, maps = _stage_geometry(geometry, params, config)
    gbuffer = jax.jit(resolve_gbuffer_from_records)(vis, records, geometry)
    t_lut = jax.jit(compute_transmittance_lut)(state.atmosphere)

    @jax.jit
    def stage(gbuffer, state, maps, t_lut):
        lit = jnp.clip(
            deferred_lighting(
                gbuffer, state.camera, state.directional_lights, state.directional_count,
                state.directional_skip_count, state.spot_lights, state.spot_count, maps,
                pcf_f16=True, shadowless_eps=config.shadowless_strength_eps,
            ),
            0.0, 1.0,
        )
        atmo, cam = state.atmosphere, state.camera
        origin = cam.position[:3] / 1e6 * jnp.array([1.0, -1.0, 1.0]) + jnp.array([0.0, atmo.planet_radius_mm, 0.0])
        return lit, pack_lut_q8(compute_skyview_lut(atmo, origin, t_lut, width=128, height=64))

    lit, q8 = stage(gbuffer, state, maps, t_lut)
    _, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    return state, vis, gbuffer, maps, t_lut, lit, q8, prepare_frame_state(params_t)


# The reference's compiled pass leaves its own op-by-op pass on two kinds of
# pixel row. Where a camera ray sees the sky, its sky-view lookup moves: on
# some x86 hosts the compiled _skyview_uv takes the horizon's sine one ulp
# away, and a camera metres above the ground turns that into 1e-4 of v and
# up to 2e-3 of the color (ROADMAP Queue 3). Where the ray grazes the
# planet, the per-pixel integral's 32 steps each take a segment
# transmittance, a ratio of two LUT samples whose coordinates cancel in
# f32, and which products a compiler contracts inside the loop decides the
# value: up to 5e-3. So every pixel row is held to HDR_RTOL, relative to
# the row's largest value (or to 1, the frame's clamp, where that is
# larger), beyond the reference's own spread in that row, and the sky's
# pixels to HDR_RTOL of the reference's op-by-op pass.
HDR_RTOL = 1e-5
GRAZING_DEG = 5.0  # a ray this close to the planet's tangent grazes it


def ray_classes(pstate, shape):
    """Per pixel of the pass's grid, from the camera and the planet radius
    alone (in float64): (sees the sky: the camera ray misses the planet;
    grazes: the ray meets the planet less than GRAZING_DEG from its
    tangent plane)."""
    from syzygy_tpu_torch.kernels.sky import camera_rays

    position, direction, _, _ = camera_rays(pstate.camera, pstate.atmosphere, *shape, (PASS_W, PASS_H))
    o, d = position.double().numpy(), direction.double().numpy()
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    radius = float(pstate.atmosphere.planet_radius_mm)
    b = -(d @ o)
    discriminant = radius * radius - np.sum((o + b[..., None] * d) ** 2, axis=-1)
    t0 = b - np.sqrt(np.maximum(discriminant, 0.0))
    hit = (discriminant >= 0.0) & (t0 > 0.0)
    normal = (o + t0[..., None] * d) / radius
    grazes = hit & (-np.sum(d * normal, axis=-1) < np.sin(np.radians(GRAZING_DEG)))
    return ~hit, grazes


MODES = [
    dict(metallic_reflection=True, fast=False, fast_reflection=False),
    dict(metallic_reflection=True, fast=False, fast_reflection=True),
    dict(metallic_reflection=True, fast=True, fast_reflection=False),
    dict(metallic_reflection=False, fast=False, fast_reflection=False),
    dict(metallic_reflection=False, fast=True, fast_reflection=True),
]


def _mode_id(mode):
    return "-".join(k for k, v in mode.items() if v) or "plain"


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
@pytest.mark.parametrize("sun_time", [None, 0.35], ids=["low_sun", "daylight"])
def test_sky_camera_pass_exact_matches_reference(sun_time, mode):
    """``sky_camera_pass(aerial=None)``: the per-pixel 32-step integral,
    the unshared environment and the reflected environment."""
    from syzygy_tpu.kernels.atmosphere import pack_lut
    from syzygy_tpu.kernels.sky import sky_camera_pass

    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.kernels.sky import sky_camera_pass as port_pass

    state, vis, gbuffer, maps, t_lut, lit, q8, pstate = pass_inputs(sun_time)

    def reference(lit, depth, gbuffer, state, maps, t_lut, q8):
        sun = jax.tree.map(lambda x: x[0], state.directional_lights)
        return sky_camera_pass(
            lit, depth, gbuffer, state.camera, state.atmosphere, pack_lut(t_lut), q8, sun, maps[0],
            draw_extent=(PASS_W, PASS_H), aerial=None, pcf_f16=True, **mode,
        )

    ref, op_by_op = reference_compiled_and_op_by_op(reference, lit, vis.depth, gbuffer, state, maps, t_lut, q8)
    spread = own_spread_rows(ref, op_by_op)
    sun = type(pstate.directional_lights)(*[x[0] for x in pstate.directional_lights])
    port = port_pass(
        t(lit), t(vis.depth), GBuffer(*[t(x) for x in gbuffer]), pstate.camera, pstate.atmosphere,
        t(t_lut), port_q8(q8), sun, t(maps[0]), (PASS_W, PASS_H), aerial=None, pcf_f16=True, **mode,
    ).numpy()
    assert np.isfinite(port).all()
    assert ref.max() > 2.0  # the frame holds HDR values
    scale = np.maximum(np.abs(ref).reshape(ref.shape[0], -1).max(axis=1), 1.0)
    # the reference leaves itself by more than HDR_RTOL of a row's scale on
    # some rows, by more than ten times that only on rows whose rays see the
    # sky or graze the planet, and most rows do neither
    sees_sky, grazes = ray_classes(pstate, ref.shape[:2])
    banded = sees_sky.any(axis=1) | grazes.any(axis=1)
    noisy = spread / scale > 10 * HDR_RTOL
    print(
        f"exact sky pass {_mode_id(mode)}: rows over 10 x HDR_RTOL {np.nonzero(noisy)[0].tolist()}; "
        f"rows seeing the sky {np.nonzero(sees_sky.any(axis=1))[0][[0, -1]].tolist()}, "
        f"grazing {np.nonzero(grazes.any(axis=1))[0][[0, -1]].tolist()} (first, last)"
    )
    assert (spread / scale).max() > HDR_RTOL
    assert not (noisy & ~banded).any(), np.nonzero(noisy & ~banded)[0]
    assert banded.sum() < ref.shape[0] / 2
    assert_rows_within_own_spread(port, ref, spread, HDR_RTOL * scale, f"exact sky pass {_mode_id(mode)}")
    # the sky's pixels sample the sky-view with the reference's formulas
    sky = sees_sky & (np.asarray(vis.depth) == 0)
    sky_err = (np.abs(port - op_by_op).max(axis=-1) / scale[:, None])[sky]
    print(f"exact sky pass {_mode_id(mode)}: {sky.sum()} sky pixels, max |port - op-by-op| / scale {sky_err.max():.3e}")
    assert sky.sum() > 5000 and sky_err.max() <= HDR_RTOL


def test_sky_camera_pass_row_origin_is_a_row_slice():
    """``row_origin``: the pass on rows [64, 144) of its inputs is bitwise
    those rows of the whole pass (both formulations' rays depend on the
    global row only)."""
    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.kernels.sky import sky_camera_pass as port_pass

    state, vis, gbuffer, maps, t_lut, lit, q8, pstate = pass_inputs(None)
    sun = type(pstate.directional_lights)(*[x[0] for x in pstate.directional_lights])
    gb = GBuffer(*[t(x) for x in gbuffer])

    def run(rows, origin):
        return port_pass(
            t(lit)[rows], t(vis.depth)[rows], GBuffer(*[x[rows] for x in gb]), pstate.camera,
            pstate.atmosphere, t(t_lut), port_q8(q8), sun, t(maps[0]), (PASS_W, PASS_H),
            aerial=None, pcf_f16=True, row_origin=origin, fast=True,
        )

    whole = run(slice(None), 0)
    assert torch.equal(run(slice(64, None), 64), whole[64:])


# --------------------------------------------------------------------------
# whole frames
# --------------------------------------------------------------------------


FRAME_W, FRAME_H = 256, 144


@functools.lru_cache(maxsize=None)
def frame_inputs():
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    from syzygy_tpu_torch.interop import from_reference

    scene, lib = reference_flagship()
    config = RenderConfig(
        width=FRAME_W, height=FRAME_H, shadow_dim=256, skyview_width=256, skyview_height=128, n_shadow_maps=4,
    )
    geometry = pack_geometry(scene, lib, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, FRAME_W / FRAME_H)
    geo_t, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    return geometry, params, geo_t, params_t, config


@pytest.mark.parametrize(
    "overrides",
    [
        dict(aerial_lut=False, fast_sky_reflection=False),
        dict(aerial_lut=False),
        dict(aerial_lut=False, fast_sky=True),
        dict(fast_sky=True),
    ],
    ids=["quirk_exact", "exact_fast_reflection", "exact_fast_sky", "aerial_fast_sky"],
)
def test_frame_matches_reference(overrides):
    """Whole frames of the chess flagship, 256x144, against
    ``syzygy_tpu.renderer.render_frame`` at the same config: RMSE <= 1e-3
    (the frame class); the first is ``tools/parity_1080p.py``'s config."""
    from syzygy_tpu.renderer import render_frame

    from syzygy_tpu_torch.renderer.frame import render_frame as port_frame

    geometry, params, geo_t, params_t, config = frame_inputs()
    config = dataclasses.replace(config, **overrides)
    ref = np.asarray(render_frame(geometry, params, config))
    out = port_frame(geo_t, params_t, port_config(config)).numpy()
    assert out.shape == (FRAME_H, FRAME_W, 3) and np.isfinite(out).all()
    err = rmse(out, ref)
    print(f"frame {overrides}: RMSE {err:.3e}, max {np.abs(out - ref).max():.3e}")
    assert err <= 1e-3
