"""The chess flagship through the port's own glTF path vs the reference.

* ``chess_set``: meshes, node specs and textures bitwise the JAX's;
* ``flagship_scene`` (written and loaded through the port's GLB writer,
  PNG codec and loader): packed geometry and atlas bitwise the JAX
  ``pack_geometry(quad_pack=False, joint_pack=False)`` of the JAX
  flagship scene, crossed over with ``interop.from_reference``;
* at the golden config (``tests/test_golden_flagship.py:42-56``, camera
  from the port's own ``eulers_from_forward``): visibility ids equal
  ``flagship_vis_512x288.npz`` exactly; the lit-only and the full frame
  within RMSE 1e-3 of ``flagship_lit_512x288.npz`` /
  ``flagship_512x288.npz`` (the reference's budget; the goldens are the
  JAX frames in u16);
* ``sky_camera_pass`` with the metallic bounce, fed the reference's own
  chess G-buffer (metallic 0.05 on the pieces), vs the JAX pass: 1e-4 of
  its op-by-op value wherever the frame's clamp resolves the value, and
  within the reference's own compiled-vs-op-by-op spread plus 1e-4 (1e-5
  relative per row on the HDR glint of the low sun on the planet's
  ground) of its compiled value; the same pass's sky pixels stage by
  stage within 1e-5 of the op-by-op pass;
* the builtin scenes and ``python -m syzygy_tpu_torch.app`` (``--scene``,
  ``--gltf``) on the CPU.
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

from test_golden_flagship import FLAGSHIP_FRAME, FLAGSHIP_LIT, FLAGSHIP_VIS, load_u16
from test_torch_common import (
    assert_rows_within_own_spread,
    own_spread_rows,
    port_q8,
    reference_compiled_and_op_by_op,
    rmse,
    to_numpy_dict,
)

W, H = 512, 288
EYE = (13.0, -8.0, -14.0)  # bench.py:264-271
TARGET = (0.0, -1.0, 0.0)


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def reference_flagship():
    from syzygy_tpu.assets.chess import flagship_scene
    from syzygy_tpu.math.geometry import eulers_from_forward

    scene, lib = flagship_scene()  # built through PIL and loaded, as the golden tests do
    scene.tick(0.0)
    eye = np.asarray(EYE, np.float32)
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(np.asarray(eulers_from_forward(np.asarray(TARGET, np.float32) - eye)))
    return scene, lib


@functools.lru_cache(maxsize=None)
def port_flagship():
    from syzygy_tpu_torch.assets.chess import flagship_scene
    from syzygy_tpu_torch.math.geometry import eulers_from_forward

    scene, lib = flagship_scene()
    scene.tick(0.0)
    scene.camera.position = EYE
    forward = torch.tensor(TARGET) - torch.tensor(EYE)
    scene.camera.euler_angles = tuple(float(x) for x in eulers_from_forward(forward))
    return scene, lib


def golden_config(**overrides):
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    return RenderConfig(width=W, height=H, shadow_dim=512, skyview_width=256, skyview_height=128, **overrides)


@functools.lru_cache(maxsize=None)
def port_packed():
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    scene, lib = port_flagship()
    return pack_geometry(scene, lib, "cpu"), upload_frame_params(pack_frame_params(scene, W / H), "cpu")


# --------------------------------------------------------------------------
# assets
# --------------------------------------------------------------------------


def test_chess_set_matches_reference():
    from syzygy_tpu.assets.chess import chess_set as reference_chess_set

    from syzygy_tpu_torch.assets.chess import chess_set

    ref_meshes, ref_nodes, ref_lib = reference_chess_set()
    meshes, nodes, lib = chess_set()
    assert nodes == ref_nodes
    assert len(meshes) == len(ref_meshes) == 13
    for m, r in zip(meshes, ref_meshes):
        assert m.name == r.name
        for name in ("positions", "normals", "uvs", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(m, name), getattr(r, name), err_msg=f"{m.name}.{name}")
        assert [(s.first_tri, s.tri_count, dataclasses.astuple(s.material)) for s in m.surfaces] == [
            (s.first_tri, s.tri_count, dataclasses.astuple(s.material)) for s in r.surfaces
        ]
    assert len(lib) == len(ref_lib)
    for i in range(len(lib)):
        np.testing.assert_array_equal(lib.get(i), ref_lib.get(i), err_msg=f"texture {i}")


def test_flagship_packing_matches_reference():
    """Port scene (its GLB writer, PNG codec and loader) -> port packing
    equals the reference scene (PIL, JAX loader) -> reference packing."""
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    from syzygy_tpu_torch.interop import from_reference

    scene, lib = reference_flagship()
    ref_geo = pack_geometry(scene, lib, quad_pack=False, joint_pack=False)
    ref_t, _ = from_reference(to_numpy_dict(ref_geo), to_numpy_dict(pack_frame_params(scene, W / H)), "cpu")
    geometry, _ = port_packed()
    assert int(geometry.tri_valid.sum()) == 14_316
    assert geometry.tex_rects_mips is None and ref_t.tex_rects_mips is None
    for name in set(geometry._fields) - {"tex_rects_mips"}:
        assert torch.equal(getattr(geometry, name), getattr(ref_t, name)), name


@pytest.mark.parametrize("name", ["default", "sphere", "chessboard", "flagship"])
def test_builtin_scenes_match_reference(name):
    """``app.scenes.builtin_scene``: the same packed arrays, and the same
    metallic auto-off decision, as the reference's builtin scenes."""
    from syzygy_tpu.app.scenes import builtin_scene as reference_builtin
    from syzygy_tpu.scene import pack_geometry, scene_uses_metallic

    from syzygy_tpu_torch.app.scenes import builtin_scene
    from syzygy_tpu_torch.scene.pack import pack_geometry_host
    from syzygy_tpu_torch.scene.pack import scene_uses_metallic as port_uses_metallic

    scene, lib = builtin_scene(name)
    ref_scene, ref_lib = reference_builtin(name)
    port = pack_geometry_host(scene, lib)
    ref = pack_geometry(ref_scene, ref_lib, quad_pack=False, joint_pack=False)
    for key, value in port.items():
        np.testing.assert_array_equal(value, np.asarray(getattr(ref, key)), err_msg=key)
    assert port_uses_metallic(scene, lib) == scene_uses_metallic(ref_scene, ref_lib)
    assert port_uses_metallic(scene, lib) == (name in ("chessboard", "flagship"))


# --------------------------------------------------------------------------
# the golden config
# --------------------------------------------------------------------------


def test_flagship_visibility_ids_match_golden():
    """The camera raster's triangle ids equal the reference golden exactly
    (``test_golden_flagship.py:77-86``)."""
    from syzygy_tpu_torch.kernels.raster import rasterize, setup_triangles
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    geometry, params = port_packed()
    config = golden_config()
    state = prepare_frame_state(params)
    clip, _ = transform_positions(
        geometry.positions, geometry.vert_instance, state.models,
        matmul4(state.camera.projection, state.camera.view),
    )
    setup = setup_triangles(
        clip, geometry.triangles, geometry.tri_valid, W, H, 1,
        grid_width=config.padded_width, grid_height=config.padded_height,
    )
    tri = rasterize(setup, config.padded_width, config.padded_height).tri[:H, :W].numpy()
    golden = np.load(FLAGSHIP_VIS)["tri"]
    assert int((tri != golden).sum()) == 0
    assert (tri >= 0).sum() > 10_000


@functools.lru_cache(maxsize=None)
def port_frame(render_atmosphere: bool) -> np.ndarray:
    from syzygy_tpu_torch.renderer.frame import render_frame

    geometry, params = port_packed()
    if not render_atmosphere:  # test_golden_flagship.py:89-98
        params = params._replace(directional_skip_count=torch.tensor(0, dtype=torch.int32))
    return render_frame(geometry, params, golden_config(render_atmosphere=render_atmosphere)).numpy()


@pytest.mark.parametrize("render_atmosphere,golden", [(False, FLAGSHIP_LIT), (True, FLAGSHIP_FRAME)], ids=["lit", "full"])
def test_flagship_frame_matches_golden(render_atmosphere, golden):
    frame = port_frame(render_atmosphere)
    assert frame.shape == (H, W, 3) and np.isfinite(frame).all()
    assert rmse(frame, load_u16(golden)) <= 1e-3


# --------------------------------------------------------------------------
# the metallic bounce, on the reference's own chess G-buffer
# --------------------------------------------------------------------------


PASS_W, PASS_H = 256, 144  # the pass at a cut size: the same pixels' math, less reference time
T_MAX = 4000 / 1e6  # the aerial volume's depth, Mm
HDR_RTOL = 1e-5  # beyond the reference's own spread, of a row's largest HDR value


@functools.lru_cache(maxsize=None)
def bounce_inputs():
    """The reference's inputs of the pass with the metallic bounce, on the
    chess flagship at the default config (aerial LUT on): (geometry, params,
    state, vis, gbuffer, maps, t_lut, pass_args), ``pass_args`` those of
    :func:`reference_bounce_pass`, the LUTs and the lit color compiled in
    one ``jax.jit``."""
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut, compute_transmittance_lut, pack_lut, pack_lut_q8
    from syzygy_tpu.kernels.lighting import deferred_lighting
    from syzygy_tpu.kernels.resolve import resolve_gbuffer_from_records
    from syzygy_tpu.kernels.sky import build_aerial_lut, compute_skyview_tseg, pack_tseg_rows
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.renderer.frame import _stage_geometry
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    scene, lib = reference_flagship()
    config = RenderConfig(width=PASS_W, height=PASS_H, shadow_dim=256, skyview_width=128, skyview_height=64)
    geometry = pack_geometry(scene, lib, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, PASS_W / PASS_H)
    state, vis, records, maps = _stage_geometry(geometry, params, config)
    gbuffer = jax.jit(resolve_gbuffer_from_records)(vis, records, geometry)
    t_lut = jax.jit(compute_transmittance_lut)(state.atmosphere)

    @jax.jit
    def luts(gbuffer, state, maps, t_lut):
        lit = jnp.clip(
            deferred_lighting(
                gbuffer, state.camera, state.directional_lights, state.directional_count,
                state.directional_skip_count, state.spot_lights, state.spot_count, maps,
                pcf_f16=True, shadowless_eps=config.shadowless_strength_eps,
            ),
            0.0, 1.0,
        )
        atmo, cam = state.atmosphere, state.camera
        t_lut = pack_lut(t_lut)
        origin = cam.position[:3] / 1e6 * jnp.array([1.0, -1.0, 1.0]) + jnp.array([0.0, atmo.planet_radius_mm, 0.0])
        q8 = pack_lut_q8(compute_skyview_lut(atmo, origin, t_lut, width=128, height=64))
        tseg = pack_tseg_rows(compute_skyview_tseg(atmo, t_lut, origin, 64))
        aerial = build_aerial_lut(atmo, t_lut, cam, origin, T_MAX)
        return lit, t_lut, q8, tseg, aerial

    lit, packed_t_lut, q8, tseg, aerial = luts(gbuffer, state, maps, t_lut)
    pass_args = (lit, vis.depth, gbuffer, state, maps, packed_t_lut, q8, tseg, aerial)
    return geometry, params, state, vis, gbuffer, maps, t_lut, pass_args


def reference_bounce_pass(lit, depth, gbuffer, state, maps, t_lut, q8, tseg, aerial):
    from syzygy_tpu.kernels.sky import sky_camera_pass

    sun = jax.tree.map(lambda x: x[0], state.directional_lights)
    return sky_camera_pass(
        lit, depth, gbuffer, state.camera, state.atmosphere, t_lut, q8, sun, maps[0],
        draw_extent=(PASS_W, PASS_H), metallic_reflection=True, aerial=aerial,
        aerial_t_max=T_MAX, tseg_rows=tseg, pcf_f16=True,
    )


@functools.lru_cache(maxsize=None)
def port_bounce_state():
    from syzygy_tpu_torch.interop import from_reference
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    geometry, params = bounce_inputs()[:2]
    _, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    return prepare_frame_state(params_t)


def port_aerial(aerial):
    from syzygy_tpu_torch.kernels.sky import AerialLUT

    volume = np.asarray(aerial.packed).reshape(32, 32, 16, 72)[..., :9]
    return AerialLUT(t(volume), t(aerial.t_sun0))


def port_bounce_pass(metallic_reflection: bool) -> np.ndarray:
    """The port's pass on :func:`bounce_inputs`."""
    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.kernels.sky import sky_camera_pass

    _, _, _, vis, gbuffer, maps, t_lut, pass_args = bounce_inputs()
    lit, q8, tseg, aerial = pass_args[0], pass_args[6], pass_args[7], pass_args[8]
    pstate = port_bounce_state()
    return sky_camera_pass(
        t(lit), t(vis.depth), GBuffer(*[t(x) for x in gbuffer]), pstate.camera, pstate.atmosphere,
        t(t_lut), port_q8(q8), type(pstate.directional_lights)(*[x[0] for x in pstate.directional_lights]),
        t(maps[0]), (PASS_W, PASS_H), port_aerial(aerial), T_MAX, t(tseg),
        metallic_reflection=metallic_reflection, pcf_f16=True,
    ).numpy()


@functools.lru_cache(maxsize=None)
def reference_bounce_colors():
    """(compiled, op by op) of the reference's pass on :func:`bounce_inputs`."""
    return reference_compiled_and_op_by_op(reference_bounce_pass, *bounce_inputs()[-1])


def test_sky_camera_pass_metallic_bounce_matches_reference():
    """``sky_camera_pass`` (metallic bounce on) from the reference's lit
    color, depth, G-buffer, LUTs and sun map of the chess flagship, where
    metallic is 0.05 on every piece: 1e-4 of the reference's op-by-op pass
    wherever the frame's clamp resolves the value, and within the
    reference's own compiled-vs-op-by-op spread of its compiled pass."""
    gbuffer = bounce_inputs()[4]
    metallic = np.asarray(gbuffer.orm)[..., 2]
    assert (metallic > 0.04).sum() > 500  # the bounce is live on the pieces

    ref, op_by_op = reference_bounce_colors()
    port = port_bounce_pass(metallic_reflection=True)
    # every pixel the frame's [0, 1] clamp can resolve (all geometry, the
    # metallic pieces included, and the sky away from the sun): the 1e-4
    # class of the default scene's pass, against the reference's formulas
    resolved = (ref <= 1.0).all(axis=-1)
    assert resolved.sum() > 0.9 * resolved.size
    np.testing.assert_allclose(port[resolved], op_by_op[resolved], atol=1e-4, rtol=0)
    # the compiled reference leaves its own formulas in the sky (its
    # _skyview_uv moves v: ROADMAP Queue 3), by 2e-3 on some x86 hosts: per
    # value, the port is held to that spread plus the class
    spread = np.abs(op_by_op - ref)
    err = np.abs(port - ref)
    print(
        f"metallic bounce: max |port - op-by-op| {np.abs(port - op_by_op)[resolved].max():.3e} (resolved), "
        f"max |port - compiled| {err[resolved].max():.3e}, reference's own spread {spread[resolved].max():.3e}"
    )
    assert (err[resolved] <= spread[resolved] + 1e-4).all()
    # the low sun's glint on the planet's ground below the horizon (HDR,
    # clamped to 1 in the frame): sampleGround's microfacet term
    # pow(dot(halfway, normal), 160) turns a last-bit difference of the dot
    # into ~160x that relative error, and the grazing ray's planet hit and
    # transmittance cancel catastrophically. On each row 1e-5 of the row's
    # largest HDR value beyond the reference's own spread in that row (as
    # the quirk-exact pass, test_torch_sky_exact.py), from the compiled pass
    # and from the op-by-op pass
    hdr = (~resolved)[..., None]
    scale_rows = np.where(hdr, np.abs(ref), 0.0).reshape(ref.shape[0], -1).max(axis=1)
    spread_rows = own_spread_rows(ref, np.where(hdr, op_by_op, ref))
    for name, anchor in (("compiled", ref), ("op-by-op", op_by_op)):
        assert_rows_within_own_spread(
            np.where(hdr, port, anchor), anchor, spread_rows, HDR_RTOL * scale_rows,
            f"metallic bounce, HDR pixels against the {name} pass",
        )
    off = port_bounce_pass(metallic_reflection=False)
    assert np.abs(port - off).max() > 1e-3  # the bounce term is not zero here


# The stages of the pass on a sky pixel (depth 0, a camera ray that misses
# the planet), in the order the pass computes them.
SKY_STAGES = ("direction", "u", "v", "sky", "disk", "aerial", "before_clamp", "color")


def reference_sky_stages(state, t_lut, q8, aerial, world_position, shape):
    """The reference's pass (``sky.py:644-676``, the miss branch of
    ``sample_environment_shared``, ``sky.py:810-822``) up to each stage, for
    rays that miss the planet -> {stage: array}."""
    from syzygy_tpu.kernels import sky as ref_sky
    from syzygy_tpu.kernels.atmosphere import sample_lut_bilinear, sample_transmittance_rmu, safe_sqrt

    h, w = shape
    atmo, cam = state.atmosphere, state.camera
    flip = jnp.array([1.0, -1.0, 1.0], jnp.float32)
    up_r = jnp.array([0.0, atmo.planet_radius_mm, 0.0], jnp.float32)
    position = cam.position[:3] / 1e6 * flip + up_r
    xs = (jnp.arange(w, dtype=jnp.float32)[None, :] / PASS_W - 0.5) * 2.0
    ys = (jnp.arange(h, dtype=jnp.float32)[:, None] / PASS_H - 0.5) * 2.0
    clip_uv = jnp.stack([jnp.broadcast_to(xs, (h, w)), jnp.broadcast_to(ys, (h, w))], axis=-1)
    ones = jnp.ones((h, w, 1), jnp.float32)
    view_h = jnp.concatenate([clip_uv, ones, ones], axis=-1) @ cam.inverse_projection.T
    direction = (view_h @ cam.rotation.T)[..., :3]
    direction = direction / ref_sky._norm3(direction) * flip
    pos = jnp.broadcast_to(position, direction.shape)
    u, v = ref_sky._skyview_uv(atmo, pos, direction)
    sky = sample_lut_bilinear(q8, u, v)
    r_ray = ref_sky._norm3(pos)[..., 0]
    mu_ray = jnp.sum(pos * direction, axis=-1) / (r_ray * ref_sky._norm3(direction)[..., 0])
    t_ray = sample_transmittance_rmu(t_lut, atmo, r_ray, mu_ray)
    to_sun = -atmo.incident_direction_sun
    cos_dir_sun = jnp.sum(direction * to_sun, axis=-1) / (ref_sky._norm3(direction)[..., 0] * jnp.linalg.norm(to_sun))
    edge0 = 0.2 * atmo.sun_angular_radius
    smooth = jnp.clip(
        (safe_sqrt(1.0 - cos_dir_sun * cos_dir_sun) - edge0) / jnp.maximum(atmo.sun_angular_radius - edge0, 1e-12),
        0.0, 1.0,
    )
    disk = jnp.where(
        (cos_dir_sun < 0.0)[..., None], 0.0, t_ray * (1.0 - smooth * smooth * (3.0 - 2.0 * smooth))[..., None]
    )
    uv = jnp.stack([jnp.broadcast_to(xs * 0.5 + 0.5, (h, w)), jnp.broadcast_to(ys * 0.5 + 0.5, (h, w))], axis=-1)
    surface = world_position[..., :3] * flip / 1e6 + up_r
    aerial_sample = ref_sky.sample_aerial_lut(aerial, uv, jnp.linalg.norm(surface - pos, axis=-1), T_MAX)[0]
    before_clamp = (sky + disk) * atmo.sun_intensity_spectrum * 10.0
    color = jnp.power(jnp.maximum(before_clamp, 0.0), 1.2)
    return dict(
        direction=direction, u=u, v=v, sky=sky, disk=disk, aerial=aerial_sample,
        before_clamp=before_clamp, color=color,
    )


def port_sky_stages(pstate, t_lut, q8, aerial, world_position, shape):
    """The port's pass up to each stage, for rays that miss the planet
    (``kernels/sky.py::camera_rays``, ``sample_environment_shared``,
    ``sky_camera_pass``) -> ({stage: array}, planet hit)."""
    from syzygy_tpu_torch.kernels import sky as port_sky
    from syzygy_tpu_torch.kernels.atmosphere import sample_lut_bilinear, sample_transmittance_rmu

    atmo = pstate.atmosphere
    position, direction, xs, ys = port_sky.camera_rays(pstate.camera, atmo, *shape, (PASS_W, PASS_H))
    pos = position.expand(direction.shape)
    hit, _ = port_sky._hit_planet_fma(atmo, pos, direction)
    u, v = port_sky._skyview_uv(atmo, pos, direction)
    sky = sample_lut_bilinear(q8, u, v)
    r_ray = port_sky._norm3(pos)[..., 0]
    mu_ray = torch.sum(pos * direction, dim=-1) / (r_ray * port_sky._norm3(direction)[..., 0])
    t_ray = sample_transmittance_rmu(t_lut, atmo, r_ray, mu_ray)
    disk = port_sky._sun_disk(atmo, direction, t_ray)
    uv = torch.stack([(xs * 0.5 + 0.5).expand(*shape), (ys * 0.5 + 0.5).expand(*shape)], dim=-1)
    zero = torch.zeros_like(atmo.planet_radius_mm)
    surface = world_position[..., :3] * port_sky._flip("cpu") / 1e6 + torch.stack([zero, atmo.planet_radius_mm, zero])
    aerial_sample = port_sky.sample_aerial_lut(aerial, uv, port_sky.vec_norm(surface - pos), T_MAX)[0]
    before_clamp = (sky + disk) * atmo.sun_intensity_spectrum * 10.0
    color = torch.pow(torch.clamp(before_clamp, min=0.0), 1.2)
    stages = dict(
        direction=direction, u=u, v=v, sky=sky, disk=disk, aerial=aerial_sample,
        before_clamp=before_clamp, color=color,
    )
    return {k: x.numpy() for k, x in stages.items()}, hit.numpy()


def reference_skyview_v(sin_horizon, cos_view_zenith):
    """``_skyview_uv``'s v (``sky.py:42-58``) from the sine of the horizon's
    zenith angle and the ray's cosine of zenith, op by op."""
    from syzygy_tpu.kernels.atmosphere import safe_sqrt

    with jax.disable_jit():
        horizon_zenith = jnp.pi - jnp.arcsin(jnp.clip(sin_horizon, -1.0, 1.0))
        view_zenith = jnp.arccos(jnp.clip(cos_view_zenith, -1.0, 1.0))
        above = cos_view_zenith > -safe_sqrt(1.0 - sin_horizon * sin_horizon)
        v_above = (1.0 - safe_sqrt(1.0 - view_zenith / jnp.maximum(horizon_zenith, 1e-12))) * 0.5
        v_below = safe_sqrt((view_zenith - horizon_zenith) / jnp.maximum(jnp.pi - horizon_zenith, 1e-12)) * 0.5 + 0.5
        return np.asarray(jnp.where(above, v_above, v_below))


def test_sky_pass_stages_follow_the_op_by_op_reference():
    """The metallic-bounce pass on its resolved sky pixels (depth 0, rays
    that miss the planet), stage by stage: the view ray, the sky-view
    coordinates u and v, the q8 sky-view sample, the sun disk, the aerial
    volume's sample, the color before the clamp and the color. At every
    stage the port is within 1e-5 of the reference's op-by-op value (the
    same compiled LUTs in both); the compiled reference's move from it is
    printed, with v recomputed op by op from the horizon's sine one ulp
    either side (ROADMAP Queue 3, "Limits, not faults")."""
    from syzygy_tpu.kernels.sky import _norm3

    _, _, state, vis, gbuffer, _, t_lut, pass_args = bounce_inputs()
    packed_t_lut, q8, aerial = pass_args[5], pass_args[6], pass_args[8]
    shape = tuple(vis.depth.shape)
    world_position = np.asarray(gbuffer.world_position)

    def reference(state, t_lut, q8, aerial, world_position):
        return reference_sky_stages(state, t_lut, q8, aerial, world_position, shape)

    compiled, op_by_op = reference_compiled_and_op_by_op(reference, state, packed_t_lut, q8, aerial, world_position)
    port, hit = port_sky_stages(port_bounce_state(), t(t_lut), port_q8(q8), port_aerial(aerial), t(world_position), shape)
    ref_color = reference_bounce_colors()
    sky = (np.asarray(vis.depth) == 0) & ~hit & (ref_color[0] <= 1.0).all(axis=-1)
    assert sky.sum() > 5000
    # the stages are the pass's: its color on these pixels, both ways
    np.testing.assert_array_equal(compiled["color"][sky], ref_color[0][sky])
    np.testing.assert_array_equal(op_by_op["color"][sky], ref_color[1][sky])

    print(f"{sky.sum()} sky pixels: stage, max |port - op-by-op|, max |compiled - op-by-op| (median, share bitwise)")
    for stage in SKY_STAGES:
        p, c, o = port[stage][sky], compiled[stage][sky], op_by_op[stage][sky]
        move = np.abs(c - o)
        print(
            f"  {stage:12s} {np.abs(p - o).max():.3e}  {move.max():.3e} "
            f"({np.median(move):.3e}, {np.mean(move == 0):.3f})"
        )
    for stage in SKY_STAGES:
        np.testing.assert_allclose(port[stage][sky], op_by_op[stage][sky], atol=1e-5, rtol=0, err_msg=stage)

    with jax.disable_jit():
        atmo = state.atmosphere
        position = state.camera.position[:3] / 1e6 * jnp.array([1.0, -1.0, 1.0]) + jnp.array([0.0, atmo.planet_radius_mm, 0.0])
        sin_horizon = np.float32(atmo.planet_radius_mm / _norm3(position)[0])
        direction = jnp.asarray(op_by_op["direction"])
        cos_view_zenith = np.asarray(direction / _norm3(direction))[..., 1]
    for ulps in (-1, 0, 1):
        s = np.nextafter(sin_horizon, np.float32(2 * ulps)) if ulps else sin_horizon
        v = reference_skyview_v(s, cos_view_zenith)[sky]
        print(
            f"  v op by op at sin_horizon {s!r} ({ulps:+d} ulp): max |v - compiled v| "
            f"{np.abs(v - compiled['v'][sky]).max():.3e}, share bitwise {np.mean(v == compiled['v'][sky]):.3f}"
        )


@pytest.mark.parametrize("source", ["--scene=flagship", "--gltf=assets/sphere.glb"])
def test_app_renders_on_cpu(source, tmp_path):
    """``python -m syzygy_tpu_torch.app --scene flagship`` and ``--gltf``
    with ``--device cpu``."""
    from syzygy_tpu_torch.app.__main__ import main
    from syzygy_tpu_torch.utils.png import read_png

    flag, value = source.split("=")
    if flag == "--gltf":
        value = os.path.join(os.path.dirname(__file__), "..", value)
    main([
        flag, value, "--frames", "1", "--width", "64", "--height", "32", "--shadow-dim", "128",
        "--skyview-scale", "16", "--out", str(tmp_path), "--device", "cpu",
    ])
    frame = read_png(str(tmp_path / "frame_0000.png"))
    assert frame.shape == (32, 64, 4) and frame[..., :3].std() > 0


def test_flagship_glb_file_matches_in_memory_scene(tmp_path):
    """``build_flagship_glb`` + ``flagship_scene(path)`` (a file) gives the
    in-memory flagship scene."""
    from syzygy_tpu_torch.assets.chess import build_flagship_glb, flagship_scene
    from syzygy_tpu_torch.scene.pack import pack_geometry_host

    path = str(tmp_path / "flagship.glb")
    build_flagship_glb(path)
    from_file = pack_geometry_host(*flagship_scene(path))
    in_memory = pack_geometry_host(*flagship_scene())
    for key, value in in_memory.items():
        np.testing.assert_array_equal(from_file[key], value, err_msg=key)
