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
  chess G-buffer (metallic 0.05 on the pieces), vs the JAX pass: 1e-4
  wherever the frame's clamp resolves the value, relative 2e-4 on the
  HDR glint of the low sun on the planet's ground;
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
from test_torch_common import rmse, to_numpy_dict

W, H = 512, 288
EYE = (13.0, -8.0, -14.0)  # bench.py:264-271
TARGET = (0.0, -1.0, 0.0)


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
    for name in geometry._fields:
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


def test_sky_camera_pass_metallic_bounce_matches_reference():
    """``sky_camera_pass`` (metallic bounce on) from the reference's lit
    color, depth, G-buffer, LUTs and sun map of the chess flagship, where
    metallic is 0.05 on every piece: 1e-4, as the default scene's pass."""
    from syzygy_tpu.kernels.atmosphere import compute_skyview_lut, compute_transmittance_lut, pack_lut, pack_lut_q8
    from syzygy_tpu.kernels.lighting import deferred_lighting
    from syzygy_tpu.kernels.resolve import resolve_gbuffer_from_records
    from syzygy_tpu.kernels.sky import build_aerial_lut, compute_skyview_tseg, pack_tseg_rows, sky_camera_pass
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.renderer.frame import _stage_geometry
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    from syzygy_tpu_torch.interop import from_reference
    from syzygy_tpu_torch.kernels.atmosphere import LUTQ8
    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.kernels.sky import AerialLUT
    from syzygy_tpu_torch.kernels.sky import sky_camera_pass as port_pass
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    scene, lib = reference_flagship()
    config = RenderConfig(width=PASS_W, height=PASS_H, shadow_dim=256, skyview_width=128, skyview_height=64)
    geometry = pack_geometry(scene, lib, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, PASS_W / PASS_H)
    state, vis, records, maps = _stage_geometry(geometry, params, config)
    gbuffer = jax.jit(resolve_gbuffer_from_records)(vis, records, geometry)
    metallic = np.asarray(gbuffer.orm)[..., 2]
    assert (metallic > 0.04).sum() > 500  # the bounce is live on the pieces

    t_lut = jax.jit(compute_transmittance_lut)(state.atmosphere)

    @jax.jit
    def reference(gbuffer, state, maps, vis_depth, t_lut):
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
        aerial = build_aerial_lut(atmo, t_lut, cam, origin, 4000 / 1e6)
        sun = jax.tree.map(lambda x: x[0], state.directional_lights)
        color = sky_camera_pass(
            lit, vis_depth, gbuffer, cam, atmo, t_lut, q8, sun, maps[0],
            draw_extent=(PASS_W, PASS_H), metallic_reflection=True, aerial=aerial,
            aerial_t_max=4000 / 1e6, tseg_rows=tseg, pcf_f16=True,
        )
        return color, lit, q8, tseg, aerial

    ref, lit, q8, tseg, aerial = reference(gbuffer, state, maps, vis.depth, t_lut)

    words = np.asarray(q8.words)
    codes = np.stack([(words[:, j] >> (8 * b)) & 255 for j in range(3) for b in range(4)], -1)
    port_q8 = LUTQ8(
        torch.from_numpy(codes.astype(np.uint8).reshape(64, 128, 12)),
        torch.from_numpy(words[:, 3].view(np.float32).reshape(64, 128).copy()),
    )
    volume = np.asarray(aerial.packed).reshape(32, 32, 16, 72)[..., :9]
    _, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    pstate = prepare_frame_state(params_t)

    def t(x):
        return torch.from_numpy(np.array(x))

    port = port_pass(
        t(lit), t(vis.depth), GBuffer(*[t(x) for x in gbuffer]), pstate.camera, pstate.atmosphere,
        t(t_lut), port_q8, type(pstate.directional_lights)(*[x[0] for x in pstate.directional_lights]),
        t(maps[0]), (PASS_W, PASS_H), AerialLUT(t(volume), t(aerial.t_sun0)), 4000 / 1e6, t(tseg),
        metallic_reflection=True, pcf_f16=True,
    ).numpy()
    ref = np.asarray(ref)
    # every pixel the frame's [0, 1] clamp can resolve (all geometry, the
    # metallic pieces included, and the sky away from the sun): the 1e-4
    # class of the default scene's pass
    resolved = (ref <= 1.0).all(axis=-1)
    assert resolved.sum() > 0.9 * resolved.size
    np.testing.assert_allclose(port[resolved], ref[resolved], atol=1e-4, rtol=0)
    # the low sun's glint on the planet's ground below the horizon (HDR,
    # clamped to 1 in the frame): sampleGround's microfacet term
    # pow(dot(halfway, normal), 160) turns a last-bit difference of the dot
    # into ~160x that relative error; relative 2e-4
    np.testing.assert_allclose(port[~resolved], ref[~resolved], rtol=2e-4, atol=0)
    off = port_pass(
        t(lit), t(vis.depth), GBuffer(*[t(x) for x in gbuffer]), pstate.camera, pstate.atmosphere,
        t(t_lut), port_q8, type(pstate.directional_lights)(*[x[0] for x in pstate.directional_lights]),
        t(maps[0]), (PASS_W, PASS_H), AerialLUT(t(volume), t(aerial.t_sun0)), 4000 / 1e6, t(tseg),
        metallic_reflection=False, pcf_f16=True,
    ).numpy()
    assert np.abs(port - off).max() > 1e-3  # the bounce term is not zero here


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
