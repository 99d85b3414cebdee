"""The frame enqueued without a host sync, on the CPU.

(a) Light masks: ``kernels/lighting.py::light_activity``'s map mask is
the JAX package's ``_shadow_pass`` active set, and ``deferred_lighting``
with device counts matches the reference's ``deferred_lighting`` with
counts (1e-5) over seeded light sets (zero lights, skip counts,
``shadowless_strength_eps`` 0 and 0.025, spots on and off), and is
bitwise the compacted host-list loop the port ran before its masks.
(b) Binning: ``bin_triangles`` with static sizes lists per tile the slots
of exact binning, and sets its overflow flag exactly when a slot would
drop (the pair budget or a tile's capacity exceeded).
(c) The full-iteration raster (``capacity=0``) and a listed raster whose
lists overflowed are bitwise the listed raster, and match the JAX
package's ``rasterize`` (K3/K4, interpret mode) in the visibility class.
(d) No host reads: a 256x128 CPU frame renders with ``Tensor.item``,
``tolist``, ``__bool__``, ``__int__`` and ``__float__`` patched to raise
outside ``rasterize_plain`` (the kernel's plain stand-in, which reads its
lists on the host), and with no host-to-tensor constant made once the
first frame has made them: the CPU's proxy for a frame with no sync.
(e) ``tile_list_capacity=0`` (and 1: every list overflows) frames are
bitwise the default frame.

The ``cuda``-marked tests hold the CUDA graph replay to the eager frame
and the frame to no sync on the card; they skip without a GPU. This file
imports JAX only inside its reference tests, so those run on a GPU host
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dispatch.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from syzygy_tpu_torch.kernels import raster
from syzygy_tpu_torch.kernels.raster import CHUNK, TILE_H, TILE_W, bin_triangles, pair_budget, setup_triangles

LIGHT_TOL = 1e-5


# --------------------------------------------------------------------------
# (a) light masks
# --------------------------------------------------------------------------

# (spot_count, directional_skip, night, shadowless eps, n_shadow_maps)
MAP_CASES = [
    (0, 0, False, 0.0, 10),
    (0, 2, False, 0.025, 10),  # no directional lights
    (1, 1, False, 0.025, 10),
    (3, 0, True, 0.025, 10),
    (3, 1, True, 0.0, 10),
    (5, 0, False, 0.025, 4),
    (16, 0, True, 0.025, 18),
]


@pytest.mark.parametrize("case", MAP_CASES, ids=[f"spots{c[0]}_skip{c[1]}_{'night' if c[2] else 'day'}_eps{c[3]}_maps{c[4]}" for c in MAP_CASES])
def test_map_mask_is_the_reference_active_set(case, monkeypatch):
    """Tolerance: exact. The reference's ``_shadow_pass`` with its raster
    replaced by a map of ones (so a slot is nonzero exactly when the
    reference rasters it) against ``light_activity``'s map mask."""
    import jax
    import jax.numpy as jnp
    from syzygy_tpu.kernels.resolve import transform_positions as ref_transform
    from syzygy_tpu.renderer import frame as ref_frame
    from syzygy_tpu.scene.pack import prepare_frame_state as ref_prepare
    from test_torch_common import reference_inputs, to_numpy_dict

    from syzygy_tpu_torch.interop import from_reference
    from syzygy_tpu_torch.kernels.lighting import light_activity
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    spot_count, skip, night, eps, n_maps = case
    geometry, params, _, _, config = reference_inputs("default")
    angles = np.asarray(params.atmosphere.sun_euler_angles, np.float32).copy()
    if night:
        angles[0] = -angles[0]  # the sun below the horizon: the moon lights
    params = params._replace(
        spot_count=np.int32(spot_count), directional_skip_count=np.int32(skip),
        atmosphere=params.atmosphere._replace(sun_euler_angles=angles),
    )
    config = dataclasses.replace(config, shadowless_strength_eps=eps, n_shadow_maps=n_maps)

    def ones_raster(setup, width, height, config, **_):
        return raster.VisibilityBuffer(jnp.ones((height, width), jnp.float32), None, None, None)

    monkeypatch.setattr(ref_frame, "_dispatch_raster", ones_raster)

    @functools.partial(jax.jit, static_argnames="config")
    def reference(geometry, params, config):
        state = ref_prepare(params)
        _, world = ref_transform(
            geometry.positions, geometry.vert_instance, state.models, state.camera.projection @ state.camera.view
        )
        world_h = jnp.concatenate([world, jnp.ones((world.shape[0], 1), jnp.float32)], axis=-1)
        return jnp.any(ref_frame._shadow_pass(geometry, world_h, state, config) != 0, axis=(1, 2))

    want = np.asarray(reference(geometry, params, config))
    _, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    state = prepare_frame_state(params_t)
    got = light_activity(
        state.directional_lights, state.directional_count, state.directional_skip_count,
        state.spot_lights, state.spot_count, eps, n_maps,
    ).shadow_maps.numpy()
    assert got.shape == (min(n_maps, 18),)
    np.testing.assert_array_equal(got, want[: got.shape[0]])
    assert not want[got.shape[0]:].any()
    assert got[0]  # the sun's map: the sky pass samples it


def _light_set(seed):
    """Seeded inputs of one lighting case, as numpy: an 8x64 G-buffer of
    random surfaces (a sixteenth of it background), two directional
    lights and four spots with identity light matrices (texture space is
    the world's [-1, 1] square), 32^2 depth maps of random occluders, and
    the counts. Odd seeds zero a light's strength; seed 3 makes the
    second directional light dim (the shadowless gate's case)."""
    rng = np.random.default_rng(seed)
    h, w = 8, 64

    def unit(shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    alpha = (rng.uniform(size=(h, w, 1)) > 1 / 16).astype(np.float32)
    gbuffer = [
        np.concatenate([rng.uniform(0.1, 0.9, (h, w, 3)), alpha], -1),
        np.concatenate([rng.uniform(0.0, 1.0, (h, w, 3)), np.ones((h, w, 1))], -1),
        np.concatenate([unit((h, w, 3)), np.zeros((h, w, 1))], -1),
        np.concatenate([rng.uniform(-0.9, 0.9, (h, w, 2)), rng.uniform(0.05, 0.95, (h, w, 1)), np.ones((h, w, 1))], -1),
        np.concatenate([rng.uniform(0.0, 1.0, (h, w, 3)), np.ones((h, w, 1))], -1),
    ]
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    strength = rng.uniform(0.2, 1.0, 2).astype(np.float32)
    if seed % 2:
        strength[seed % 4 // 2] = 0.0
    if seed == 3:
        strength[1] = 0.004
    directional = dict(
        color=np.concatenate([rng.uniform(0.2, 1.0, (2, 3)), np.ones((2, 1))], -1).astype(np.float32),
        forward=np.concatenate([-unit((2, 3)) * [1, 1, 1], np.zeros((2, 1))], -1).astype(np.float32),
        projection=eye, view=eye, strength=strength,
    )
    n_spot = 4
    spot_strength = rng.uniform(0.5, 3.0, n_spot).astype(np.float32)
    if seed % 2:
        spot_strength[seed % n_spot] = 0.0
    spots = dict(
        color=np.concatenate([rng.uniform(0.2, 1.0, (n_spot, 3)), np.ones((n_spot, 1))], -1).astype(np.float32),
        forward=np.concatenate([unit((n_spot, 3)), np.zeros((n_spot, 1))], -1).astype(np.float32),
        projection=np.tile(np.eye(4, dtype=np.float32), (n_spot, 1, 1)),
        view=np.tile(np.eye(4, dtype=np.float32), (n_spot, 1, 1)),
        position=np.concatenate([rng.uniform(-2.0, 2.0, (n_spot, 3)), np.ones((n_spot, 1))], -1).astype(np.float32),
        strength=spot_strength,
        falloff_factor=np.full(n_spot, 0.5, np.float32),
        falloff_distance=np.full(n_spot, 4.0, np.float32),
    )
    maps = np.where(rng.uniform(size=(2 + n_spot, 32, 32)) < 0.3, 0.0, rng.uniform(size=(2 + n_spot, 32, 32)))
    return [g.astype(np.float32) for g in gbuffer], directional, spots, maps.astype(np.float32)


# (seed, directional_count, directional_skip, spot_count, shadowless eps)
LIGHT_CASES = [
    (0, 0, 0, 0, 0.0),  # zero lights
    (1, 2, 0, 4, 0.0),
    (2, 2, 1, 2, 0.025),
    (3, 2, 0, 0, 0.025),  # spots off; the dim second light unshadowed
    (4, 1, 0, 3, 0.025),
    (5, 2, 2, 4, 0.0),  # every directional skipped
]


def _compacted_lighting(gbuffer, camera, directional, counts, spots, maps, eps):
    """The port's lighting before its masks: light lists read on the host,
    then shadowed directionals, dim ones and spots added in turn."""
    from syzygy_tpu_torch.kernels import lighting as L

    count, skip, n_spots = (int(c) for c in counts)
    material = L.convert_pbr(gbuffer)
    view_dir = L._normalize(camera.position[:3] - material.position)
    total = torch.zeros_like(material.position)
    dir_int = torch.amax(torch.abs(directional.color[:, :3]), -1) * torch.abs(directional.strength)
    if eps > 0.0:
        daylight = torch.clamp(torch.sum(-directional.forward[:, :3] * L.world_up("cpu"), -1), 0.0, 1.0)
        needs = (dir_int >= eps * torch.sum(dir_int * daylight)).tolist()
    else:
        needs = [True] * 2
    emits = ((torch.amax(torch.abs(directional.color[:, :3]), -1) * directional.strength) != 0.0).tolist()
    live = [i for i in range(2) if skip <= i < count and emits[i]]

    def contribution(i, shadow):
        light = L._take(directional, i)
        spectral = (light.color[:3] * light.strength) * shadow[..., None]
        return L._light_contribution(material, view_dir, L._normalize(-light.forward[:3]), spectral)

    for i in [i for i in live if needs[i]]:
        total = total + contribution(i, L.directional_pcf(L._take(directional, i), material, maps[i], f16=True))
    for i in [i for i in live if not needs[i]]:
        total = total + contribution(i, torch.ones_like(material.position[..., 0]))
    s_emits = ((torch.amax(torch.abs(spots.color[:, :3]), -1) * spots.strength) != 0.0).tolist()
    for j in [j for j in range(spots.strength.shape[0]) if j < n_spots and s_emits[j]]:
        spot = L._take(spots, j)
        coord, dx, dy = L.compute_shadow_frame(L.matmul4(spot.projection, spot.view), material.position, material.normal)
        shadow = L.sample_shadow_map(maps[2 + j], coord, dx, dy, f16=True)
        dist = L.vec_norm(spot.position[:3] - material.position, dim=-1, keepdim=True)
        norm_dist = dist / spot.falloff_distance
        falloff = spot.falloff_factor * norm_dist * norm_dist
        uv_dist = torch.clamp(L.vec_norm(coord[..., :2] - 0.5, dim=-1, keepdim=True) / 0.5, 0.0, 1.0)
        spectral = (spot.color[:3] * spot.strength) / torch.clamp(falloff, min=1e-8) * (1.0 - uv_dist * uv_dist) * shadow[..., None]
        total = total + L._light_contribution(material, view_dir, L._normalize(-spot.forward[:3]), spectral)
    return torch.where(gbuffer.diffuse[..., 3:4] >= 1.0, total, 0.0)


@pytest.mark.parametrize("case", LIGHT_CASES, ids=[f"seed{c[0]}_dirs{c[1]}_skip{c[2]}_spots{c[3]}_eps{c[4]}" for c in LIGHT_CASES])
def test_masked_lighting_matches_reference_and_compacted_loop(case):
    """Tolerance: 1e-5 against the reference's ``deferred_lighting`` with
    device counts (compiled, clamped as the frame clamps); bitwise the
    port's compacted host-list loop."""
    import jax
    import jax.numpy as jnp
    from syzygy_tpu.kernels.lighting import deferred_lighting as ref_lighting
    from syzygy_tpu.kernels.resolve import GBuffer as RefGBuffer
    from syzygy_tpu.scene import Camera
    from syzygy_tpu.scene.lights import DirectionalLight as RefDirectional
    from syzygy_tpu.scene.lights import SpotLight as RefSpot

    from syzygy_tpu_torch.kernels.lighting import deferred_lighting, light_activity
    from syzygy_tpu_torch.kernels.resolve import GBuffer
    from syzygy_tpu_torch.scene.camera import CameraPacked
    from syzygy_tpu_torch.scene.lights import DirectionalLight, SpotLight

    seed, count, skip, n_spots, eps = case
    gbuffer, directional, spots, maps = _light_set(seed)
    cam = Camera(position=(0.0, -5.0, 0.0)).packed(1.0)
    counts = [np.int32(count), np.int32(skip), np.int32(n_spots)]

    @functools.partial(jax.jit, static_argnames="eps")
    def reference(gbuffer, cam, directional, spots, maps, counts, eps):
        return ref_lighting(
            gbuffer, cam, directional, counts[0], counts[1], spots, counts[2], maps, pcf_f16=True, shadowless_eps=eps
        )

    ref = np.asarray(reference(
        RefGBuffer(*[jnp.asarray(g) for g in gbuffer]), cam,
        RefDirectional(**{k: jnp.asarray(v) for k, v in directional.items()}),
        RefSpot(**{k: jnp.asarray(v) for k, v in spots.items()}), jnp.asarray(maps), [jnp.asarray(c) for c in counts], eps,
    ))
    port_args = (
        GBuffer(*[torch.from_numpy(g) for g in gbuffer]), CameraPacked(*[torch.from_numpy(np.asarray(x)) for x in cam]),
        DirectionalLight(**{k: torch.from_numpy(v) for k, v in directional.items()}),
        [torch.tensor(c) for c in counts], SpotLight(**{k: torch.from_numpy(v) for k, v in spots.items()}),
        torch.from_numpy(maps),
    )
    gb, camera, dirs, counts_t, spot_t, maps_t = port_args
    port = deferred_lighting(gb, camera, dirs, counts_t[0], counts_t[1], spot_t, counts_t[2], maps_t, pcf_f16=True, shadowless_eps=eps)
    np.testing.assert_allclose(np.clip(port.numpy(), 0, 1), np.clip(ref, 0, 1), atol=LIGHT_TOL, rtol=0)
    compacted = _compacted_lighting(gb, camera, dirs, counts_t, spot_t, maps_t, eps)
    assert torch.equal(port.view(torch.int32), compacted.view(torch.int32))
    activity = light_activity(dirs, *counts_t[:2], spot_t, counts_t[2], eps, 6)
    lit = int(activity.shadowed_dirs.sum() + activity.unshadowed_dirs.sum() + activity.spots.sum())
    assert (lit == 0) == (not port.any())
    if seed == 3:
        assert activity.unshadowed_dirs.tolist() == [False, True]


# --------------------------------------------------------------------------
# (b) binning
# --------------------------------------------------------------------------


def _screen_setup(corners, z, width, height):
    """The setup of screen-space triangles (pixels, w = 1, no cull) on a
    ``width`` x ``height`` target."""
    corners = np.asarray(corners, np.float64)
    ndc = np.concatenate([corners / [width, height] * 2.0 - 1.0, np.asarray(z, np.float64)[..., None]], axis=-1)
    clip = np.concatenate([ndc, np.ones(ndc.shape[:-1] + (1,))], axis=-1).astype(np.float32)
    n = clip.shape[0]
    return setup_triangles(
        torch.from_numpy(clip.reshape(-1, 4)), torch.arange(n * 3, dtype=torch.int32).reshape(n, 3),
        torch.ones(n, dtype=torch.bool), width, height, 0,
    )


def _random_screen_setup(seed, n, width=512, height=256, size=40.0, big=0):
    """``n`` seeded triangles of up to ``size`` px and ``big`` that cover
    the whole target."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform([0.0, 0.0], [width, height], size=(n, 1, 2))
    corners = centre + rng.uniform(-size, size, size=(n, 3, 2))
    whole = np.tile(np.array([[[-10.0, -10.0], [3.0 * width, -10.0], [-10.0, 3.0 * height]]]), (big, 1, 1))
    corners = np.concatenate([corners, whole])
    return _screen_setup(corners, rng.uniform(0.05, 0.95, size=(n + big, 3)), width, height)


def _exact_lists(coeffs, tiles_y, tiles_x):
    c = coeffs.numpy().astype(np.int64)
    tx0, tx1p, ty0, ty1p = c[:, 10] // 4096, c[:, 10] % 4096, c[:, 11] // 4096, c[:, 11] % 4096
    return [
        np.nonzero((tx >= tx0) & (tx < tx1p) & (ty >= ty0) & (ty < ty1p))[0]
        for ty in range(tiles_y) for tx in range(tiles_x)
    ]


# (seed, triangles, size, whole-target triangles, capacity)
BIN_CASES = [
    (0, 300, 40.0, 0, 448),
    (1, 1500, 40.0, 2, 1),  # tiles hold more than 64 slots: overflow
    (2, 60, 12.0, 0, 1),  # small lists within capacity 1
    (3, 20, 40.0, 100, 448),  # 100 whole-target triangles exceed the pair budget
    (4, 0, 40.0, 1, 2),
]


@pytest.mark.parametrize("case", BIN_CASES, ids=[f"seed{c[0]}_n{c[1]}_big{c[3]}_cap{c[4]}" for c in BIN_CASES])
def test_static_binning_lists_exact_slots_and_flags_drops(case):
    """Tolerance: exact. Per tile the slot set (ascending) of exact
    binning whenever no slot drops; the overflow flag set exactly when
    the pairs exceed the budget or a tile lists more than ``capacity *
    CHUNK`` slots."""
    seed, n, size, big, capacity = case
    width, height = 512, 256
    setup = _random_screen_setup(seed, n, width, height, size, big)
    lists = bin_triangles(setup.coeffs, height, width, capacity)
    tiles_y, tiles_x = height // TILE_H, width // TILE_W
    exact = _exact_lists(setup.coeffs, tiles_y, tiles_x)
    n_slots = setup.coeffs.shape[0]
    budget = pair_budget(n_slots, tiles_y * tiles_x, capacity)
    total = sum(len(e) for e in exact)
    drops = total > budget or max(len(e) for e in exact) > capacity * CHUNK
    assert lists.slots.shape == (budget,) and lists.offsets.shape == (tiles_y * tiles_x + 1,)
    assert bool(lists.overflow) == drops
    assert drops == (seed in (1, 3))  # the cases are what they say
    if not drops:
        offsets = lists.offsets.numpy()
        for tile, want in enumerate(exact):
            np.testing.assert_array_equal(lists.slots.numpy()[offsets[tile] : offsets[tile + 1]], want)
        assert offsets[-1] == total


def test_binning_budget_is_sized_from_the_capacity():
    """One tile per slot plus CHUNK whole-target slots, never more than
    the tiles' lists of ``capacity * CHUNK`` slots hold; capacity 0 has
    no lists."""
    assert pair_budget(1024, 8, 448) == 1024 + CHUNK * 8
    assert pair_budget(1024, 8, 1) == 8 * CHUNK
    assert pair_budget(0, 8, 448) == 1
    with pytest.raises(ValueError):
        bin_triangles(torch.zeros((64, 12)), 128, 256, 0)


# --------------------------------------------------------------------------
# (c) the full-iteration raster
# --------------------------------------------------------------------------


def _assert_same_raster(a, b, depth_only):
    for name in ("depth",) if depth_only else ("depth", "tri", "b0", "b1"):
        assert torch.equal(getattr(a, name).view(torch.int32), getattr(b, name).view(torch.int32)), name


@pytest.mark.parametrize("depth_only", [False, True])
def test_full_iteration_matches_listed_and_reference(depth_only):
    """Bitwise: ``rasterize`` at ``capacity=0`` (K3/K4) and at capacity 1
    (the dense field's lists overflow: the device flag takes full
    iteration) equal the listed raster. Visibility class (ids exact but
    within 1e-4 of an edge, depth and barycentrics 1e-5) against the
    reference's full-iteration ``rasterize`` in interpret mode."""
    from syzygy_tpu.kernels.raster import rasterize as ref_rasterize
    from test_torch_raster import _check_vis, _port_setup, camera_inputs

    _, _, setup, _, _, config = camera_inputs("dense")
    w, h = config.padded_width, config.padded_height
    port_setup = _port_setup("dense")
    listed = raster.rasterize(port_setup, w, h, depth_only=depth_only)
    full = raster.rasterize(port_setup, w, h, depth_only=depth_only, capacity=0)
    assert bool(bin_triangles(port_setup.coeffs, h, w, 1).overflow)
    overflowed = raster.rasterize(port_setup, w, h, depth_only=depth_only, capacity=1)
    _assert_same_raster(full, listed, depth_only)
    _assert_same_raster(overflowed, listed, depth_only)
    ref = ref_rasterize(setup, w, h, depth_only=depth_only, unroll=True, vector=True)
    _check_vis(full, ref, setup.coeffs, depth_only)


def test_full_iteration_keeps_the_listing_rule():
    """A sliver's f32 test passes outside its tile range; full iteration
    tests it only where its range lists it, as the listed raster does, so
    both give the same bits (tolerance: exact)."""
    from test_torch_kernel import _setup

    setup, w, h, origin = _setup("sliver")
    listed = raster.rasterize(setup, w, h, origin=origin)
    full = raster.rasterize_plain(setup, w, h, origin=origin, full=True)
    _assert_same_raster(full, listed, False)
    assert bool((listed.tri == 0).any())


# --------------------------------------------------------------------------
# (d) no host reads; (e) capacity 0
# --------------------------------------------------------------------------

HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__")
CONSTANT_MAKERS = ("tensor", "as_tensor", "from_numpy")


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Host reads of a tensor and host-to-tensor constants raise, but
    inside ``rasterize_plain``, the kernel's plain stand-in."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    makers = {name: getattr(torch, name) for name in CONSTANT_MAKERS}
    plain = raster.rasterize_plain

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"the frame called {name} outside a plain kernel stand-in")
        return fn

    def patch():
        for name in HOST_READS:
            monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        for name in CONSTANT_MAKERS:
            monkeypatch.setattr(torch, name, refuse(f"torch.{name}"))

    def stand_in(*args, **kwargs):
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        for name, fn in makers.items():
            setattr(torch, name, fn)
        try:
            return plain(*args, **kwargs)
        finally:
            patch()

    monkeypatch.setattr(raster, "rasterize_plain", stand_in)
    patch()
    try:
        yield
    finally:
        monkeypatch.undo()


@functools.lru_cache(maxsize=None)
def _golden_frame_inputs():
    from test_torch_common import port_golden_scene

    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry

    scene, lib, config = port_golden_scene()
    host = pack_frame_params(scene, config.width / config.height, debug_lines=True)
    spec = frame_param_spec(host)
    return pack_geometry(scene, lib, "cpu"), host, spec, flatten_frame_params(host, spec), config


@pytest.mark.parametrize("overrides", [{}, {"tile_list_capacity": 1, "debug_lines": True}], ids=["default", "overflow_lines"])
def test_frame_reads_nothing_back(overrides, monkeypatch):
    """``render_frame``, ``render_frame_packed`` and ``render_frame_rows``
    at 256x128 on the CPU, each bitwise its frame rendered before the
    patch."""
    from syzygy_tpu_torch.renderer.frame import render_frame, render_frame_packed, render_frame_rows
    from syzygy_tpu_torch.scene.pack import upload_frame_params

    geometry, host, spec, row, config = _golden_frame_inputs()
    config = dataclasses.replace(config, **overrides)
    params = upload_frame_params(host, "cpu")
    torch_row = torch.from_numpy(row)
    want = render_frame(geometry, params, config)  # makes the device constants
    want_rows = render_frame_rows(geometry, params, config, 0, TILE_H)
    with _no_host_reads(monkeypatch):
        frame = render_frame(geometry, params, config)
        packed = render_frame_packed(geometry, torch_row, spec, config)
        rows = render_frame_rows(geometry, params, config, 0, TILE_H)
    assert torch.equal(frame, want) and torch.equal(packed, want) and torch.equal(rows, want_rows)


def test_host_reads_are_refused_by_the_proxy(monkeypatch):
    """The proxy bites: a read of a tensor on the host raises inside it."""
    with _no_host_reads(monkeypatch), pytest.raises(AssertionError, match="Tensor.item"):
        torch.ones(()).item()
    assert torch.ones(()).item() == 1.0


@pytest.mark.parametrize("scene", ["default", "flagship"])
def test_capacity_zero_frame_is_the_default_frame(scene):
    """Bitwise: a frame at ``tile_list_capacity=0`` (every raster by full
    iteration) and at 1 (lists overflow) is the default frame."""
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    if scene == "default":
        geometry, host, _, _, config = _golden_frame_inputs()
    else:
        from syzygy_tpu_torch.bench import chess_scene

        chess, lib = chess_scene()
        config = RenderConfig(width=128, height=64, shadow_dim=256, skyview_width=128, skyview_height=64)
        geometry = pack_geometry(chess, lib, "cpu")
        host = pack_frame_params(chess, config.width / config.height)
    params = upload_frame_params(host, "cpu")
    want = render_frame(geometry, params, config)
    for capacity in (0, 1):
        got = render_frame(geometry, params, dataclasses.replace(config, tile_list_capacity=capacity))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), capacity


# --------------------------------------------------------------------------
# on the card: replay
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs and the raster kernel have no CPU mode)")
    return torch.device("cuda")


def _card_frame_inputs(device, **overrides):
    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, lib = default_scene()
    scene.tick(0.0)
    config = RenderConfig(**(dict(width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64) | overrides))
    host = pack_frame_params(scene, config.width / config.height)
    spec = frame_param_spec(host)
    return pack_geometry(scene, lib, device), host, spec, flatten_frame_params(host, spec), config, scene


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [448, 0, 1])
def test_replay_is_the_eager_frame_and_syncs_nothing(cuda, capacity):
    """Bitwise: the first call (eager warm-up and capture) and replays
    after the row changes equal ``render_frame_eager``; the eager frame
    and the replays run under ``set_sync_debug_mode("error")``."""
    from syzygy_tpu_torch.renderer.frame import render_frame_eager, render_frame_packed
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, pack_frame_params, upload_frame_params

    geometry, host, spec, row, config, scene = _card_frame_inputs(cuda, tile_list_capacity=capacity)
    hosts = [host]
    for _ in range(2):
        scene.tick(600.0)
        hosts.append(pack_frame_params(scene, config.width / config.height))
    rows = [flatten_frame_params(h, spec) for h in hosts]
    params = [upload_frame_params(h, cuda) for h in hosts]  # pageable uploads: the test's, before the mode
    first = render_frame_packed(geometry, row, spec, config)
    torch.cuda.set_sync_debug_mode("error")
    try:  # the comparisons read the card: after the mode
        eager = [render_frame_eager(geometry, p, config) for p in params]
        replays = [render_frame_packed(geometry, rows[k], spec, config) for k in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, eager[0])
    for replay, want in zip(replays, eager[1:]):
        assert not torch.equal(replay, first)
        assert torch.equal(replay, want)


@pytest.mark.cuda
def test_replay_returns_before_its_frame_ends(cuda):
    """After the capturing call, ``render_frame_packed`` returns while its
    frame still runs on the card."""
    from syzygy_tpu_torch.renderer.frame import render_frame_packed

    geometry, _, spec, row, config, _ = _card_frame_inputs(cuda, width=1920, height=1080)
    render_frame_packed(geometry, row, spec, config)
    torch.cuda.synchronize()
    render_frame_packed(geometry, row, spec, config)
    end = torch.cuda.Event()
    end.record()
    assert not end.query()
    end.synchronize()
