"""Triangle setup, binning and the visibility/shadow raster vs the reference.

(c) ``setup_triangles`` rows equal the reference's (jitted) setup bitwise;
``rasterize_plain`` matches the reference's ``rasterize_listed`` (K1/K2)
and ``rasterize`` (K3/K4) and the brute-force numpy raster of
``tests/test_raster.py`` under that file's rules: triangle ids exact except
within 1e-4 barycentric of an edge, depth atol 1e-5, barycentrics 1e-5
(the class of the reference's own vector-vs-serial raster,
``raster.py:596-603``).
(d) Shadow maps equal the reference's ``_shadow_pass`` in the same classes.
The CUDA kernel itself is compared with ``rasterize_plain`` in
``tests/test_torch_kernel.py`` (JAX-free, so it runs on a GPU host).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from test_raster import assert_raster_matches, np_reference_raster, screen_to_clip
from test_torch_common import port_config, reference_inputs

EDGE_TOL = 1e-4
DEPTH_TOL = 1e-5
BARY_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def camera_inputs(which: str):
    """Reference clip positions + jitted reference setup for the camera."""
    from syzygy_tpu.kernels.raster import setup_triangles
    from syzygy_tpu.kernels.resolve import transform_positions
    from syzygy_tpu.scene.pack import prepare_frame_state

    geometry, params, geo_t, params_t, config = reference_inputs(which)

    @jax.jit
    def clip_and_setup(geometry, params):
        state = prepare_frame_state(params)
        clip, world = transform_positions(
            geometry.positions, geometry.vert_instance, state.models,
            state.camera.projection @ state.camera.view,
        )
        setup = setup_triangles(
            clip, geometry.triangles, geometry.tri_valid, config.width, config.height,
            cull_keep_sign=1, grid_width=config.padded_width, grid_height=config.padded_height,
        )
        return clip, world, setup

    clip, world, setup = clip_and_setup(geometry, params)
    return clip, world, setup, geo_t, params_t, config


def _port_setup(which):
    from syzygy_tpu_torch.kernels.raster import setup_triangles

    clip, _, _, geo_t, _, config = camera_inputs(which)
    return setup_triangles(
        torch.from_numpy(np.array(clip)), geo_t.triangles, geo_t.tri_valid,
        config.width, config.height, 1,
        grid_width=config.padded_width, grid_height=config.padded_height,
    )


@pytest.mark.parametrize("which", ["default", "dense"])
def test_vertex_transform_bitwise(which):
    """Tolerance: exact. The port sums the small products in the reference's
    order, so clip positions (and raster coverage) agree bit for bit."""
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    clip, world, _, geo_t, params_t, _ = camera_inputs(which)
    state = prepare_frame_state(params_t)
    c, w = transform_positions(
        geo_t.positions, geo_t.vert_instance, state.models,
        matmul4(state.camera.projection, state.camera.view),
    )
    np.testing.assert_array_equal(c.numpy(), np.asarray(clip))
    np.testing.assert_array_equal(w.numpy(), np.asarray(world))


@pytest.mark.parametrize("which", ["default", "dense"])
def test_setup_bitwise(which):
    """Tolerance: exact for every TriSetup row (coefficients incl. the
    packed tile ranges, slot->triangle ids, clip-corner barycentrics, w)."""
    _, _, ref, _, _, _ = camera_inputs(which)
    port = _port_setup(which)
    for name in ("coeffs", "orig_tri", "corner_bary", "corner_w"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)


def _check_vis(port, ref, coeffs, depth_only=False):
    """The tests/test_raster.py classes, with edge distances measured from
    the (shared) setup rows."""
    if depth_only:
        np.testing.assert_allclose(port.depth.numpy(), np.asarray(ref.depth), atol=DEPTH_TOL, rtol=0)
        return
    pt, rt = port.tri.numpy(), np.asarray(ref.tri)
    differ = pt != rt
    if differ.any():
        ys, xs = np.nonzero(differ)
        px, py = xs + 0.5, ys + 0.5
        c = np.asarray(coeffs, np.float64)
        for ids in (pt[differ], rt[differ]):
            k = c[np.maximum(ids, 0)]
            b0 = k[:, 0] + k[:, 1] * px + k[:, 2] * py
            b1 = k[:, 3] + k[:, 4] * px + k[:, 5] * py
            edge = np.minimum(np.minimum(np.abs(b0), np.abs(b1)), np.abs(1 - b0 - b1))
            assert (np.where(ids >= 0, edge, 0.0) < EDGE_TOL).all(), "id flip away from an edge"
    same = ~differ
    np.testing.assert_allclose(port.depth.numpy()[same], np.asarray(ref.depth)[same], atol=DEPTH_TOL, rtol=0)
    np.testing.assert_allclose(port.b0.numpy()[same], np.asarray(ref.b0)[same], atol=BARY_TOL, rtol=0)
    np.testing.assert_allclose(port.b1.numpy()[same], np.asarray(ref.b1)[same], atol=BARY_TOL, rtol=0)


@pytest.mark.parametrize("which", ["default", "dense"])
@pytest.mark.parametrize("kernel", ["listed", "full"])
@pytest.mark.parametrize("depth_only", [False, True])
def test_raster_plain_matches_reference(which, kernel, depth_only):
    """rasterize_plain over tile lists vs the reference's listed (K1/K2),
    and by full iteration vs its full-iteration (K3/K4) Pallas rasters on
    the same setup, interpret mode."""
    from syzygy_tpu.kernels.raster import rasterize, rasterize_listed

    from syzygy_tpu_torch.kernels.raster import rasterize_plain

    _, _, setup, _, _, config = camera_inputs(which)
    w, h = config.padded_width, config.padded_height
    if kernel == "listed":
        ref, dropped = rasterize_listed(
            setup, w, h, capacity=448, depth_only=depth_only, unroll=True, vector=True
        )
        assert int(dropped) == 0
    else:
        ref = rasterize(setup, w, h, depth_only=depth_only, unroll=True, vector=True)
    port = rasterize_plain(_port_setup(which), w, h, depth_only=depth_only, full=kernel == "full")
    _check_vis(port, ref, setup.coeffs, depth_only)


def test_raster_plain_matches_numpy_reference():
    """Seeded random triangles vs the brute-force numpy raster of
    tests/test_raster.py (its assert_raster_matches rules)."""
    from syzygy_tpu_torch.kernels.raster import rasterize, setup_triangles

    width, height = 256, 128
    rng = np.random.default_rng(11)
    tris = np.concatenate(
        [
            rng.uniform([0, 0, 0.05], [width, height, 0.95], size=(24, 3, 3)),
            rng.uniform([-40, -40, 0.05], [width + 40, height + 40, 0.95], size=(8, 3, 3)),
        ]
    ).astype(np.float32)
    clip = torch.from_numpy(screen_to_clip(tris, width, height))
    n = len(tris)
    triangles = torch.arange(n * 3, dtype=torch.int32).reshape(n, 3)
    setup = setup_triangles(clip, triangles, torch.ones(n, dtype=torch.bool), width, height, 0)
    vis = rasterize(setup, width, height)
    ref_depth, ref_tri = np_reference_raster(tris, width, height)
    # slot t of input t keeps its id (no near clip: w = 1)
    assert_raster_matches(vis, tris, ref_depth, ref_tri)
    assert (ref_tri >= 0).sum() > 5000


def test_bin_triangles_exact_lists():
    """Each tile lists exactly the slots whose tile range covers it, in
    ascending slot order; nothing is dropped, so the overflow flag is
    clear."""
    from syzygy_tpu_torch.kernels.raster import TILE_H, TILE_W, bin_triangles

    setup = _port_setup("dense")
    _, _, _, _, _, config = camera_inputs("dense")
    lists = bin_triangles(setup.coeffs, config.padded_height, config.padded_width)
    c = setup.coeffs.numpy().astype(np.int64)
    tx0, tx1p = c[:, 10] // 4096, c[:, 10] % 4096
    ty0, ty1p = c[:, 11] // 4096, c[:, 11] % 4096
    offsets = lists.offsets.numpy()
    slots = lists.slots.numpy()
    assert not bool(lists.overflow)
    assert lists.tiles_x == config.padded_width // TILE_W
    assert lists.tiles_y == config.padded_height // TILE_H
    for tile in range(lists.tiles_y * lists.tiles_x):
        ty, tx = divmod(tile, lists.tiles_x)
        expect = np.nonzero((tx >= tx0) & (tx < tx1p) & (ty >= ty0) & (ty < ty1p))[0]
        np.testing.assert_array_equal(slots[offsets[tile] : offsets[tile + 1]], expect)


@pytest.mark.parametrize("which", ["default", "dense"])
def test_shadow_maps_match_reference(which):
    """(d) the whole shadow pass: every map within depth atol 1e-5 of the
    reference's _shadow_pass (no texel may flip at this config); inactive
    maps stay all-zero."""
    from syzygy_tpu.kernels.resolve import transform_positions as ref_transform
    from syzygy_tpu.renderer.frame import _shadow_pass as ref_shadow_pass
    from syzygy_tpu.scene.pack import prepare_frame_state as ref_prepare

    from syzygy_tpu_torch.kernels.lighting import light_activity
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4
    from syzygy_tpu_torch.renderer.frame import _shadow_pass
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    geometry, params, geo_t, params_t, config = reference_inputs(which)

    @functools.partial(jax.jit, static_argnames="config")
    def reference(geometry, params, config):
        import jax.numpy as jnp

        state = ref_prepare(params)
        _, world = ref_transform(
            geometry.positions, geometry.vert_instance, state.models,
            state.camera.projection @ state.camera.view,
        )
        world_h = jnp.concatenate([world, jnp.ones((world.shape[0], 1), jnp.float32)], axis=-1)
        return ref_shadow_pass(geometry, world_h, state, config)

    ref = np.asarray(reference(geometry, params, config))
    cfg = port_config(config)
    state = prepare_frame_state(params_t)
    _, world = transform_positions(
        geo_t.positions, geo_t.vert_instance, state.models,
        matmul4(state.camera.projection, state.camera.view),
    )
    activity = light_activity(
        state.directional_lights, state.directional_count, state.directional_skip_count,
        state.spot_lights, state.spot_count, cfg.shadowless_strength_eps, cfg.n_shadow_maps,
    )
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    port = _shadow_pass(geo_t, world_h, state, cfg, activity.shadow_maps).numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=DEPTH_TOL, rtol=0)
    active = torch.nonzero(activity.shadow_maps).flatten().tolist()
    assert 0 in active and any(port[i].any() for i in active)
    for i in range(port.shape[0]):
        if i not in active:
            assert not port[i].any(), f"inactive map {i} is not all-zero"


def test_cuda_tensor_never_falls_back_to_plain(monkeypatch):
    """A CUDA tensor goes to the kernel launcher, never to rasterize_plain;
    a tensor on any other device is refused."""
    from syzygy_tpu_torch.kernels import raster

    setup = _port_setup("default")
    calls = []
    monkeypatch.setattr(raster, "rasterize_plain", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(raster, "_launch_kernel", lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(raster, "bin_triangles", lambda *a, **k: None)
    fake = raster.TriSetup(setup.coeffs.to("meta"), *setup[1:])
    with pytest.raises(ValueError):
        raster.rasterize(fake, 256, 128)

    class FakeCuda:
        type = "cuda"

    class Coeffs:
        device = FakeCuda()

    raster.rasterize(raster.TriSetup(Coeffs(), *setup[1:]), 256, 128)
    assert calls == ["kernel"]
