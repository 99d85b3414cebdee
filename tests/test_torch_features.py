"""The port's remaining frame features and entry points vs the JAX package.

* debug lines: ``box_segments`` and the packed boxes bitwise; the overlay
  mask of ``draw_lines`` equal to the reference's wherever a float64
  evaluation puts the pixel further than 1e-4 from every capsule edge and
  depth tie; whole frames with lines (with the atmosphere, without it, and
  under ``supersample=2``): the frame class, RMSE <= 1e-3;
* ``render_frame_rows``: two and three stacked row blocks bitwise the
  port's whole frame, and within the frame class of the reference's
  ``render_frame_rows``; ``render_frame_packed`` bitwise ``render_frame``;
  the flattened buffer and its spec bitwise the reference's;
* ``frame_draw_stats``: exact counts on the default and flagship scenes;
* the four compute demos: exact (``boolean_push``, ``sparse_push``) and
  1e-6 (``gradient_color``, ``matrix_color``);
* gradients of ``deferred_lighting`` with respect to a spot light's color
  and the sun's direction vs ``jax.grad`` of the reference's
  ``deferred_lighting(unroll=True)``: 1e-4 relative; the inverse-rendering
  loop of ``tests/test_differentiable.py`` with ``torch.optim``;
* the app's options of the features above.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import port_config, port_golden_scene, reference_golden_scene, rmse, to_numpy_dict
from test_torch_flagship import port_flagship, reference_flagship

W, H = 256, 144


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def flagship_inputs(debug_lines: bool = True):
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    from syzygy_tpu_torch.interop import from_reference

    scene, lib = reference_flagship()
    config = RenderConfig(width=W, height=H, shadow_dim=256, skyview_width=256, skyview_height=128)
    geometry = pack_geometry(scene, lib, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, W / H, debug_lines=debug_lines)
    geo_t, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    return geometry, params, geo_t, params_t, config


# --------------------------------------------------------------------------
# debug lines
# --------------------------------------------------------------------------


def test_box_segments_match_reference():
    from syzygy_tpu.kernels.debuglines import BOX_EDGES as REF_EDGES
    from syzygy_tpu.kernels.debuglines import box_segments as reference

    from syzygy_tpu_torch.kernels.debuglines import BOX_EDGES, box_segments

    np.testing.assert_array_equal(BOX_EDGES, REF_EDGES)
    out = box_segments((1.0, -2.0, 3.0), (0.5, 1.5, 2.5))
    assert out.shape == (12, 2, 3)
    np.testing.assert_array_equal(out, reference((1.0, -2.0, 3.0), (0.5, 1.5, 2.5)))


@pytest.mark.parametrize("which", ["default", "flagship"])
def test_debug_boxes_packed_bitwise(which):
    """``pack_frame_params(debug_lines=True)``: the wireframe segments of
    every instance box and the shadow bounds, exact; off, one invalid
    segment, as the reference packs."""
    from syzygy_tpu.scene import pack_frame_params as reference_pack

    from syzygy_tpu_torch.scene.pack import pack_frame_params

    if which == "default":
        ref_scene, scene = reference_golden_scene()[0], port_golden_scene()[0]
    else:
        ref_scene, scene = reference_flagship()[0], port_flagship()[0]
    for on in (True, False):
        ref = reference_pack(ref_scene, W / H, debug_lines=on)
        out = pack_frame_params(scene, W / H, debug_lines=on)
        assert out.debug_segments.dtype == np.float32 and out.debug_valid.dtype == bool
        np.testing.assert_array_equal(out.debug_segments, ref.debug_segments)
        np.testing.assert_array_equal(out.debug_valid, ref.debug_valid)
    assert out.debug_valid.sum() == 0 and ref.debug_segments.shape == (1, 2, 3)


def _undecided(depth, segments, valid, proj_view, extent, margin=1e-4):
    """Pixels that a float64 evaluation of the capsule tests puts within
    ``margin`` of a decision: the capsule's edge, the depth compare, the
    far plane."""
    h, w = depth.shape
    seg = np.asarray(segments, np.float64)
    clip = np.concatenate([seg, np.ones((*seg.shape[:-1], 1))], -1) @ np.asarray(proj_view, np.float64).T
    w_clip = clip[..., 3]
    ndc = clip[..., :3] / np.maximum(w_clip, 1e-3)[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * extent[0]
    sy = (ndc[..., 1] * 0.5 + 0.5) * extent[1]
    sz = ndc[..., 2]
    px = np.arange(w)[None, :] + 0.5
    py = np.arange(h)[:, None] + 0.5
    near = np.zeros((h, w), bool)
    for s in np.nonzero(np.asarray(valid) & (w_clip > 1e-3).all(-1))[0]:
        dx, dy = sx[s, 1] - sx[s, 0], sy[s, 1] - sy[s, 0]
        tt = np.clip(((px - sx[s, 0]) * dx + (py - sy[s, 0]) * dy) / max(dx * dx + dy * dy, 1e-8), 0.0, 1.0)
        dist = np.sqrt((px - (sx[s, 0] + tt * dx)) ** 2 + (py - (sy[s, 0] + tt * dy)) ** 2)
        z = sz[s, 0] + tt * (sz[s, 1] - sz[s, 0])
        inside = dist <= 1.0 + margin
        near |= np.abs(dist - 1.0) < margin
        near |= inside & ((np.abs(z - depth) < margin) | (np.abs(z - 1.0) < margin))
    return near


@functools.lru_cache(maxsize=None)
def reference_geometry_stage():
    from syzygy_tpu.renderer.frame import _stage_geometry

    geometry, params, _, _, config = flagship_inputs()
    state, vis, _, _ = _stage_geometry(geometry, params, config)
    return state, vis


def test_draw_lines_mask_matches_reference():
    """The overlay over the reference's own depth buffer: the same pixels
    turn green, but for those a float64 evaluation cannot decide."""
    from syzygy_tpu.kernels.debuglines import LINE_COLOR, draw_lines

    from syzygy_tpu_torch.kernels.debuglines import draw_lines as port_lines
    from syzygy_tpu_torch.kernels.debuglines import line_coverage

    state, vis = reference_geometry_stage()
    depth = np.asarray(vis.depth)
    proj_view = np.asarray(state.camera.projection @ state.camera.view)
    rng = np.random.default_rng(0)
    color = rng.uniform(0.1, 0.9, size=(*depth.shape, 3)).astype(np.float32)
    ref = np.asarray(draw_lines(jnp.asarray(color), vis.depth, state.debug_segments, state.debug_valid, jnp.asarray(proj_view), (W, H)))
    args = (t(depth), t(state.debug_segments), t(state.debug_valid), t(proj_view), (W, H))
    out = port_lines(t(color), *args).numpy()
    ref_mask = (ref == np.asarray(LINE_COLOR)).all(-1)
    mask = line_coverage(*args).numpy()
    assert ref_mask.sum() > 1000
    decided = ~_undecided(depth, np.asarray(state.debug_segments), np.asarray(state.debug_valid), proj_view, (W, H))
    # the boxes bound their meshes tightly, so many edges tie with the depth
    # buffer: a few percent of the frame is undecidable at 1e-4
    assert decided.mean() > 0.95 and (ref_mask & decided).sum() > 1000
    np.testing.assert_array_equal(mask[decided], ref_mask[decided])
    print(f"overlay: {int(ref_mask.sum())} px, {int((mask != ref_mask).sum())} differ, all undecidable")
    np.testing.assert_array_equal(out[mask], np.broadcast_to(np.asarray(LINE_COLOR), out[mask].shape))
    np.testing.assert_array_equal(out[~mask], color[~mask])


@pytest.mark.parametrize(
    "overrides",
    [dict(debug_lines=True), dict(debug_lines=True, render_atmosphere=False),
     dict(debug_lines=True, supersample=2, width=W // 2, height=H // 2)],
    ids=["lines", "lines_no_atmosphere", "lines_supersample2"],
)
def test_debug_line_frames_match_reference(overrides):
    """Whole frames with the overlay: RMSE <= 1e-3. Without the atmosphere
    the lighting pass lights the sun too (``directional_skip_count`` 0), as
    ``tests/test_golden_flagship.py`` renders its lit-only golden; under
    supersample the reference hands the overlay (width, height), not the
    render extent, and so does the port."""
    from syzygy_tpu.renderer import render_frame

    from syzygy_tpu_torch.renderer.frame import render_frame as port_frame

    geometry, params, geo_t, params_t, config = flagship_inputs()
    config = dataclasses.replace(config, **overrides)
    if not config.render_atmosphere:
        params = params._replace(directional_skip_count=np.int32(0))
        params_t = params_t._replace(directional_skip_count=torch.tensor(0, dtype=torch.int32))
    ref = np.asarray(render_frame(geometry, params, config))
    out = port_frame(geo_t, params_t, port_config(config)).numpy()
    assert out.shape == ref.shape == (config.height, config.width, 3)
    err = rmse(out, ref)
    green = (out[..., 0] == 0) & (out[..., 1] > 0.999) & (out[..., 2] == 0)
    print(f"frame {overrides}: RMSE {err:.3e}, line pixels {int(green.sum())}")
    assert err <= 1e-3
    if config.supersample == 1:
        assert green.sum() > 1000


# --------------------------------------------------------------------------
# row blocks and the packed entry point
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def port_whole_frame(exact: bool):
    from syzygy_tpu_torch.renderer.frame import _encode, render_frame_linear

    _, _, geo_t, params_t, config = flagship_inputs(False)
    pconfig = port_config(config, **(dict(aerial_lut=False, fast_sky=True) if exact else {}))
    return _encode(render_frame_linear(geo_t, params_t, pconfig), pconfig), pconfig


@pytest.mark.parametrize("blocks,exact", [((64, 128), False), ((64, 64, 64), False), ((128, 64), True)],
                         ids=["two", "three", "two_exact_sky"])
def test_render_frame_rows_stack_bitwise(blocks, exact):
    """Row blocks of the 192-row padded frame, stacked: bitwise the whole
    padded frame (raster at a row origin, rays at a row origin)."""
    from syzygy_tpu_torch.renderer.frame import render_frame_rows

    _, _, geo_t, params_t, _ = flagship_inputs(False)
    whole, pconfig = port_whole_frame(exact)
    assert sum(blocks) == pconfig.padded_height == whole.shape[0]
    rows, row0 = [], 0
    for n in blocks:
        rows.append(render_frame_rows(geo_t, params_t, pconfig, row0, n))
        assert tuple(rows[-1].shape) == (n, pconfig.padded_width, 3)
        row0 += n
    assert torch.equal(torch.cat(rows, dim=0), whole)


def test_render_frame_rows_matches_reference():
    """Rows [64, 192) vs the reference's ``render_frame_rows``: frame class."""
    from syzygy_tpu.renderer.frame import render_frame_rows as reference_rows

    from syzygy_tpu_torch.renderer.frame import render_frame_rows

    geometry, params, geo_t, params_t, config = flagship_inputs(False)
    ref = np.asarray(jax.jit(reference_rows, static_argnums=(2, 3, 4))(geometry, params, config, 64, 128))
    out = render_frame_rows(geo_t, params_t, port_config(config), 64, 128).numpy()
    assert out.shape == ref.shape
    assert rmse(out, ref) <= 1e-3


def test_render_frame_rows_rejects_ragged_blocks():
    from syzygy_tpu_torch.renderer.frame import render_frame_rows

    _, _, geo_t, params_t, config = flagship_inputs(False)
    with pytest.raises(ValueError):
        render_frame_rows(geo_t, params_t, port_config(config), 0, 100)


def test_flatten_frame_params_bitwise():
    """The flat buffer and its spec equal the reference's; unflattened on
    the device every leaf equals its upload."""
    from syzygy_tpu.scene.pack import flatten_frame_params as reference_flatten
    from syzygy_tpu.scene.pack import frame_param_spec as reference_spec

    from syzygy_tpu_torch.interop import packed_from_reference
    from syzygy_tpu_torch.scene.pack import (
        flatten_frame_params,
        frame_param_spec,
        pack_frame_params,
        unflatten_frame_params,
        upload_frame_params,
    )

    _, ref_params, _, _, _ = flagship_inputs()
    host = pack_frame_params(port_flagship()[0], W / H, debug_lines=True)
    rspec = reference_spec(ref_params)
    spec = frame_param_spec(host)
    assert spec == packed_from_reference(np.zeros(rspec.total, np.float32), rspec)[1]
    assert tuple(spec) == tuple(rspec)
    buf = flatten_frame_params(host, spec)
    assert buf.dtype == np.float32 and buf.shape == (spec.total,)
    np.testing.assert_array_equal(buf, reference_flatten(ref_params, rspec))
    out = np.empty(spec.total, np.float32)
    assert flatten_frame_params(host, spec, out=out) is out
    back = unflatten_frame_params(spec, torch.from_numpy(buf))
    up = upload_frame_params(host, "cpu")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(up)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_render_frame_packed_bitwise():
    """``render_frame_packed`` from the reference's own (buffer, spec) pair
    is bitwise ``render_frame`` from the uploaded leaves."""
    from syzygy_tpu.scene.pack import flatten_frame_params, frame_param_spec

    from syzygy_tpu_torch.interop import packed_from_reference
    from syzygy_tpu_torch.renderer.frame import render_frame, render_frame_packed

    _, ref_params, geo_t, params_t, config = flagship_inputs()
    rspec = frame_param_spec(ref_params)
    buffer, spec = packed_from_reference(flatten_frame_params(ref_params, rspec), rspec)
    pconfig = port_config(config, debug_lines=True)
    packed = render_frame_packed(geo_t, buffer, spec, pconfig)
    assert torch.equal(packed, render_frame(geo_t, params_t, pconfig))


# --------------------------------------------------------------------------
# draw statistics, compute demos
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["default", "flagship"])
@pytest.mark.parametrize("overrides", [{}, dict(shadowless_strength_eps=0.0), dict(n_shadow_maps=1)],
                         ids=["defaults", "eps0", "one_map"])
def test_frame_draw_stats_match_reference(which, overrides):
    """Exact counts, debug lines on and off."""
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.renderer.stats import frame_draw_stats as reference_stats
    from syzygy_tpu.scene import pack_frame_params as reference_pack
    from syzygy_tpu.scene import pack_geometry as reference_geometry

    from syzygy_tpu_torch.renderer.stats import DrawStats, frame_draw_stats
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, pack_geometry_host, upload_frame_params

    if which == "default":
        (ref_scene, ref_lib, _), (scene, lib, _) = reference_golden_scene(), port_golden_scene()
    else:
        (ref_scene, ref_lib), (scene, lib) = reference_flagship(), port_flagship()
    config = RenderConfig(**overrides)
    ref_geo = reference_geometry(ref_scene, ref_lib, quad_pack=False, joint_pack=False)
    for lines in (False, True):
        ref = reference_stats(reference_pack(ref_scene, 16 / 9, debug_lines=lines), ref_geo, config)
        host = pack_frame_params(scene, 16 / 9, debug_lines=lines)
        out = frame_draw_stats(host, pack_geometry_host(scene, lib), port_config(config))
        assert set(out) == set(ref) == {"gbuffer", "shadows", "debug_lines", "total"}
        for key, value in out.items():
            assert isinstance(value, DrawStats) and tuple(value) == tuple(ref[key]), key
            assert str(value) == str(ref[key])
    # uploaded params and a device geometry count the same
    uploaded = frame_draw_stats(upload_frame_params(host, "cpu"), pack_geometry(scene, lib, "cpu"), port_config(config))
    assert uploaded == out


def test_compute_demos_match_reference():
    from syzygy_tpu.kernels import transfer as reference

    from syzygy_tpu_torch.kernels import transfer as port

    rng = np.random.default_rng(1)
    rows = rng.integers(0, 2, size=(4, 4)).astype(bool)
    top, bottom = (0.9, 0.2, 0.1, 1.0), (0.0, 0.3, 0.8, 1.0)
    mats = [rng.uniform(0, 1, size=(4, 4)).astype(np.float32) for _ in range(3)]
    for w, h in ((64, 48), (37, 21)):
        np.testing.assert_array_equal(port.boolean_push(w, h, "cpu", rows).numpy(), np.asarray(reference.boolean_push(w, h, rows)))
        np.testing.assert_array_equal(
            port.sparse_push(w, h, "cpu", top, bottom).numpy(), port.gradient_color(w, h, "cpu", top, bottom).numpy()
        )
        np.testing.assert_allclose(port.sparse_push(w, h, "cpu", top, bottom).numpy(), np.asarray(reference.sparse_push(w, h, top, bottom)), atol=1e-6, rtol=0)
        np.testing.assert_allclose(port.gradient_color(w, h, "cpu").numpy(), np.asarray(reference.gradient_color(w, h)), atol=1e-6, rtol=0)
        out = port.matrix_color(w, h, "cpu", *mats)
        assert tuple(out.shape) == (h, w, 4)
        np.testing.assert_allclose(out.numpy(), np.asarray(reference.matrix_color(w, h, *mats)), atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# gradients through the lighting pass
# --------------------------------------------------------------------------


def _lighting_setup(h=8, w=128, dim_second=False):
    """The scene of ``tests/test_differentiable.py`` in both packages: a
    flat grey floor, one spot light above it, and a sun (strength 2) for
    the direction gradient. ``dim_second`` gives the second directional
    slot a light dim enough for the shadowless gate to take its PCF."""
    from syzygy_tpu.kernels.resolve import GBuffer as RefGBuffer
    from syzygy_tpu.scene import Camera
    from syzygy_tpu.scene.lights import DirectionalLight as RefDirectional
    from syzygy_tpu.scene.lights import SpotlightParams, spot_raw

    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.scene.camera import CameraPacked
    from syzygy_tpu_torch.scene.lights import DirectionalLight, SpotRaw

    ones = np.ones((h, w, 1), np.float32)

    def plane(rgb, a=1.0):
        return np.concatenate([np.tile(np.asarray(rgb, np.float32), (h, w, 1)), ones * a], -1)

    planes = [plane((0.6, 0.6, 0.6)), plane((0.6, 0.6, 0.6)), plane((0.0, -1.0, 0.0), 0.0),
              plane((0.0, -1.0, 0.0)), plane((1.0, 0.5, 0.0))]
    cam = Camera(position=(0.0, -5.0, 0.0)).packed(1.0)
    raw, _ = spot_raw(
        [SpotlightParams(color=(0.9, 0.2, 0.1, 1.0), strength=10.0, position=(0.0, -3.0, 0.0),
                         euler_angles=(-np.pi / 2, 0.0, 0.0), falloff_distance=10.0)],
        2,
    )
    directional = dict(
        color=np.array([[1.0, 0.9, 0.8, 1.0], [0.0, 0.0, 0.0, 0.0]], np.float32),
        forward=np.array([[0.3, 0.8, 0.2, 0.0], [0.0, 0.0, 1.0, 0.0]], np.float32),
        projection=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        view=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        strength=np.array([2.0, 0.0], np.float32),
    )
    if dim_second:
        directional["color"][1] = (0.2, 0.3, 0.4, 1.0)
        directional["forward"][1] = (0.0, 1.0, 0.0, 0.0)
        directional["strength"][1] = 0.01
    smaps = np.zeros((4, 32, 32), np.float32)
    ref = (RefGBuffer(*[jnp.asarray(p) for p in planes]), cam, RefDirectional(**{k: jnp.asarray(v) for k, v in directional.items()}), raw, jnp.asarray(smaps))
    port = (
        GBuffer(*[t(p) for p in planes]),
        CameraPacked(*[t(np.asarray(x)) for x in cam]),
        DirectionalLight(**{k: t(v) for k, v in directional.items()}),
        SpotRaw(*[t(np.asarray(x)) for x in raw]),
        t(smaps),
    )
    return ref, port


GATE_EPS = 0.02  # the shadowless gate of the "gated" cases


def _reference_render(ref, color, forward, gated=False):
    from syzygy_tpu.kernels.lighting import deferred_lighting
    from syzygy_tpu.scene.lights import make_spot_batched

    gbuffer, cam, dirs, raw, smaps = ref
    spots = make_spot_batched(raw._replace(color=jnp.asarray(raw.color).at[0, :3].set(color)))
    dirs = dirs._replace(forward=dirs.forward.at[0, :3].set(forward))
    return deferred_lighting(
        gbuffer, cam, dirs, jnp.int32(2 if gated else 1), jnp.int32(0), spots, jnp.int32(1), smaps,
        unroll=True, shadowless_eps=GATE_EPS if gated else 0.0,
    )


def _port_render(port, color, forward, gated=False):
    from syzygy_tpu_torch.kernels.lighting import deferred_lighting, light_activity
    from syzygy_tpu_torch.scene.lights import make_spot_batched

    gbuffer, cam, dirs, raw, smaps = port
    raw_color = raw.color.clone()
    raw_color[0, :3] = color
    spots = make_spot_batched(raw._replace(color=raw_color))
    fwd = dirs.forward.clone()
    fwd[0, :3] = forward
    dirs = dirs._replace(forward=fwd)
    counts = [torch.tensor(v, dtype=torch.int32) for v in (2 if gated else 1, 0, 1)]
    eps = GATE_EPS if gated else 0.0
    activity = light_activity(dirs, counts[0], counts[1], spots, counts[2], eps, 4)
    active = {name: torch.nonzero(getattr(activity, name)).flatten().tolist() for name in activity._fields}
    assert active["shadowed_dirs"] == [0] and active["spots"] == [0]
    assert active["unshadowed_dirs"] == ([1] if gated else [])
    return deferred_lighting(gbuffer, cam, dirs, *counts[:2], spots, counts[2], smaps, shadowless_eps=eps)


@pytest.mark.parametrize("gated", [False, True], ids=["compacted", "gated"])
def test_lighting_gradients_match_reference(gated):
    """d(mean image)/d(spot color) and d/d(sun direction) against
    ``jax.grad`` of the reference's ``unroll=True`` form: 1e-4 relative to
    each gradient's largest component, through the port's compacted loops
    (whose host read is of comparisons only). ``gated`` adds a dim second
    directional that the shadowless gate lights without PCF."""
    ref, port = _lighting_setup(dim_second=gated)
    color0 = np.array([0.5, 0.4, 0.3], np.float32)
    forward0 = np.array([0.3, 0.8, 0.2], np.float32)
    weights = np.random.default_rng(3).uniform(0.5, 1.5, size=(8, 128, 3)).astype(np.float32)

    def ref_loss(c, f):
        return jnp.mean(_reference_render(ref, c, f, gated) * weights)

    ref_image = np.asarray(_reference_render(ref, jnp.asarray(color0), jnp.asarray(forward0), gated))
    g_color, g_forward = [np.asarray(g) for g in jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(color0), jnp.asarray(forward0))]

    color = t(color0).requires_grad_(True)
    forward = t(forward0).requires_grad_(True)
    image = _port_render(port, color, forward, gated)
    np.testing.assert_allclose(image.detach().numpy(), ref_image, atol=1e-5, rtol=0)
    torch.mean(image * t(weights)).backward()
    for name, got, want in (("color", color.grad, g_color), ("forward", forward.grad, g_forward)):
        got = got.numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 1e-4, name
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0, err_msg=name)


def test_inverse_rendering_recovers_light_color():
    """The loop of ``tests/test_differentiable.py:95`` with ``torch.optim``:
    the image is linear in the light color, the loss quadratic."""
    _, port = _lighting_setup()
    forward = torch.tensor([0.3, 0.8, 0.2])
    target_color = torch.tensor([0.8, 0.3, 0.05])
    target = _port_render(port, target_color, forward).detach()
    color = torch.tensor([0.5, 0.5, 0.5], requires_grad=True)
    optimizer = torch.optim.LBFGS([color], lr=1.0, max_iter=50, tolerance_grad=1e-12, tolerance_change=1e-14, line_search_fn="strong_wolfe")

    def closure():
        optimizer.zero_grad()
        loss = torch.mean((_port_render(port, color, forward) - target) ** 2)
        loss.backward()
        return loss

    for _ in range(3):
        optimizer.step(closure)
    np.testing.assert_allclose(color.detach().numpy(), target_color.numpy(), atol=1e-3)
    assert float(closure()) < 1e-10


# --------------------------------------------------------------------------
# the app's options
# --------------------------------------------------------------------------


def test_app_feature_options(tmp_path):
    """``--no-atmosphere --debug-lines --mipmaps --supersample 2 --oetf
    pure_gamma`` on the CPU: a frame with green lines."""
    from syzygy_tpu_torch.app.__main__ import main
    from syzygy_tpu_torch.utils.png import read_png

    main([
        "--scene", "chessboard", "--frames", "1", "--width", "96", "--height", "64", "--shadow-dim", "128",
        "--out", str(tmp_path), "--device", "cpu", "--no-atmosphere", "--debug-lines", "--mipmaps",
        "--supersample", "2", "--oetf", "pure_gamma",
    ])
    frame = read_png(str(tmp_path / "frame_0000.png"))
    assert frame.shape == (64, 96, 4)
    assert (frame[..., 1] > frame[..., 0].astype(int) + 60).sum() > 20  # the overlay's green
