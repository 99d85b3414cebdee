"""The mip-mapped resolve of the port vs the JAX package.

* ``TextureLibrary.as_atlas_mips``: atlas and (N, 6, 4) level rects bitwise
  the reference's (numpy on both sides), and ``pack_geometry(mipmaps=True)``
  with them;
* ``sample_bilinear_repeat``, ``sample_atlas_repeat`` and
  ``sample_atlas_trilinear`` on seeded coordinates (negative and > 1 for
  the REPEAT wrap, integer and fractional levels, levels outside the
  pyramid): 1e-5 absolute;
* the five G-buffer planes of ``_resolve_gbuffer_gathered`` on the chess
  flagship at 256x144, from the reference's visibility buffer: 1e-5
  absolute (positions relative to the scene's size; normals 5e-5);
* the whole frame with ``mipmaps=True`` vs
  ``syzygy_tpu.renderer.render_frame``: the frame class, RMSE <= 1e-3.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import port_config, rmse, to_numpy_dict
from test_torch_flagship import port_flagship, reference_flagship

W, H = 256, 144


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("which", ["default", "flagship"])
def test_as_atlas_mips_bitwise(which):
    """Atlas texels and level rects: exact."""
    if which == "default":
        from syzygy_tpu.scene import default_scene as reference_scene

        from syzygy_tpu_torch.scene.scene import default_scene

        ref_lib, lib = reference_scene()[1], default_scene()[1]
    else:
        ref_lib, lib = reference_flagship()[1], port_flagship()[1]
    ref_atlas, ref_rects = ref_lib.as_atlas_mips()
    atlas, rects = lib.as_atlas_mips()
    assert rects.dtype == ref_rects.dtype and rects.shape == (len(lib), 6, 4)
    np.testing.assert_array_equal(rects, ref_rects)
    assert atlas.dtype == ref_atlas.dtype
    np.testing.assert_array_equal(atlas, ref_atlas)
    # every level halves the one above until 1x1
    np.testing.assert_array_equal(rects[:, 1, 2:], np.maximum(rects[:, 0, 2:] // 2, 1))


@functools.lru_cache(maxsize=None)
def mip_inputs():
    """Reference and port geometry of the flagship with mips, and the frame
    params, crossed over as numpy."""
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    from syzygy_tpu_torch.interop import from_reference

    scene, lib = reference_flagship()
    geometry = pack_geometry(scene, lib, mipmaps=True, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, W / H)
    geo_t, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    return geometry, params, geo_t, params_t


def test_pack_geometry_mipmaps_bitwise():
    """The port's own ``pack_geometry(mipmaps=True)`` equals the
    reference's arrays carried over by ``from_reference``, leaf by leaf."""
    from syzygy_tpu_torch.scene.pack import pack_geometry

    _, _, geo_t, _ = mip_inputs()
    scene, lib = port_flagship()
    geometry = pack_geometry(scene, lib, "cpu", mipmaps=True)
    assert geometry.tex_rects_mips is not None and geometry.tex_rects_mips.dtype == torch.int32
    for name in geometry._fields:
        assert torch.equal(getattr(geometry, name), getattr(geo_t, name)), name


def _seeded_samples(n_tex, n=4096, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_tex, size=n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, size=(n, 2)).astype(np.float32)
    uv[:16] = np.array([[0.0, 0.0], [1.0, 1.0], [0.5, -0.0], [-1.0, 2.0]] * 4, np.float32)
    lod = rng.uniform(-0.5, 6.5, size=n).astype(np.float32)
    lod[:12] = np.array([0, 1, 2, 3, 4, 5, 5.0, 0.5, 1.5, 4.999, 7.0, -1.0], np.float32)
    return ids, uv, lod


def test_sample_atlas_trilinear_matches_reference():
    from syzygy_tpu.kernels.resolve import sample_atlas_repeat, sample_atlas_trilinear

    from syzygy_tpu_torch.kernels import resolve as port

    geometry, _, geo_t, _ = mip_inputs()
    ids, uv, lod = _seeded_samples(geometry.tex_rects.shape[0])
    ref = np.asarray(sample_atlas_trilinear(jnp.asarray(ids), geometry.tex_atlas, geometry.tex_rects_mips, jnp.asarray(uv), jnp.asarray(lod)))
    out = port.sample_atlas_trilinear(t(ids), geo_t.tex_atlas, geo_t.tex_rects_mips, t(uv), t(lod)).numpy()
    assert ref.max() > 0.5
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    ref0 = np.asarray(sample_atlas_repeat(jnp.asarray(ids), geometry.tex_atlas, geometry.tex_rects, jnp.asarray(uv)))
    out0 = port.sample_atlas_repeat(t(ids), geo_t.tex_atlas, geo_t.tex_rects, t(uv)).numpy()
    np.testing.assert_allclose(out0, ref0, atol=1e-5, rtol=0)
    # level 0 of the pyramid is the single-mip sample
    lod0 = port.sample_atlas_trilinear(t(ids), geo_t.tex_atlas, geo_t.tex_rects_mips, t(uv), torch.zeros(len(ids))).numpy()
    np.testing.assert_array_equal(lod0, out0)


def test_sample_bilinear_repeat_matches_reference():
    from syzygy_tpu.kernels.resolve import sample_bilinear_repeat

    from syzygy_tpu_torch.kernels.resolve import sample_bilinear_repeat as port_sample

    rng = np.random.default_rng(4)
    textures = rng.uniform(0, 1, size=(3, 16, 16, 4)).astype(np.float32)
    ids, uv, _ = _seeded_samples(3, n=1024)
    ref = np.asarray(sample_bilinear_repeat(jnp.asarray(ids), jnp.asarray(textures), jnp.asarray(uv)))
    out = port_sample(t(ids), t(textures), t(uv)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def _config():
    from syzygy_tpu.renderer import RenderConfig

    return RenderConfig(width=W, height=H, shadow_dim=256, skyview_width=256, skyview_height=128)


def test_resolve_gbuffer_gathered_matches_reference():
    """The geometry stage resolves the full G-buffer when the geometry has
    mips (``_defers_resolve`` is false): the reference's planes vs the
    port's ``resolve_gbuffer`` of the reference's visibility buffer through
    the port's own triangle setup (whose raster sees the same slot ids)."""
    from syzygy_tpu.renderer.frame import _defers_resolve, _stage_geometry

    from syzygy_tpu_torch.kernels.raster import VisibilityBuffer, rasterize, setup_triangles
    from syzygy_tpu_torch.kernels.resolve import resolve_gbuffer, transform_normals, transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    geometry, params, geo_t, params_t = mip_inputs()
    config = _config()
    assert not _defers_resolve(config, geometry)
    _, vis, gbuffer, _ = _stage_geometry(geometry, params, config)

    pconfig = port_config(config)
    state = prepare_frame_state(params_t)
    cam = state.camera
    clip, world = transform_positions(geo_t.positions, geo_t.vert_instance, state.models, matmul4(cam.projection, cam.view))
    normals = transform_normals(geo_t.normals, geo_t.vert_instance, state.model_inv_transpose)
    setup = setup_triangles(
        clip, geo_t.triangles, geo_t.tri_valid, W, H, 1,
        grid_width=pconfig.padded_width, grid_height=pconfig.padded_height,
    )
    pvis = rasterize(setup, pconfig.padded_width, pconfig.padded_height)
    same = pvis.tri.numpy() == np.asarray(vis.tri)
    assert same.mean() > 0.999 and (pvis.tri.numpy() >= 0).sum() > 3000
    rvis = VisibilityBuffer(*[t(x) for x in vis])
    port = resolve_gbuffer(rvis, setup, geo_t, world, normals)
    # the level of detail is log2 of a difference of neighbouring f32 uvs:
    # an ulp of uv is 1e-4 of a footprint of a few texels, so the blend
    # of two levels moves by 1e-5 of their difference; the normal map's
    # decode (x 255/127) and the cotangent frame double that
    tolerance = {"normal": 5e-5}
    for name in port._fields:
        ref = np.asarray(getattr(gbuffer, name))
        out = getattr(port, name).numpy()
        scale = max(1.0, float(np.abs(ref).max())) if name == "world_position" else 1.0
        np.testing.assert_allclose(out, ref, atol=tolerance.get(name, 1e-5) * scale, rtol=0, err_msg=name)
    # minification is live: the mip frame's diffuse differs from the single-mip one
    single = resolve_gbuffer(rvis, setup, geo_t._replace(tex_rects_mips=None), world, normals)
    assert float((single.diffuse - port.diffuse).abs().max()) > 1e-2


def test_mipmapped_frame_matches_reference():
    """``pack_geometry(mipmaps=True)`` end to end: frame class."""
    from syzygy_tpu.renderer import render_frame

    from syzygy_tpu_torch.renderer.frame import render_frame as port_frame

    geometry, params, geo_t, params_t = mip_inputs()
    config = _config()
    ref = np.asarray(render_frame(geometry, params, config))
    out = port_frame(geo_t, params_t, port_config(config)).numpy()
    assert out.shape == (H, W, 3) and np.isfinite(out).all()
    err = rmse(out, ref)
    print(f"mip frame: RMSE {err:.3e}, max {np.abs(out - ref).max():.3e}")
    assert err <= 1e-3
