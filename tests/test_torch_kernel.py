"""The CUDA raster kernel vs its plain torch version, without JAX.

This file imports only torch and the port, so it also runs on a GPU host
that has no JAX (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel.py

Tests marked ``cuda`` skip without a GPU; the unmarked ones check on the
CPU the row-block origin semantics the kernel shares with
``rasterize_plain``, the two rules the kernel's design rests on (no hit
lies outside a slot's ``pixel_box``; the order-free key merge equals the
serial depth test), and ``kernels/build.py`` with a stand-in compiler.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import pytest
import torch

from syzygy_tpu_torch.kernels.build import LAUNCHES
from syzygy_tpu_torch.kernels.raster import (
    TILE_H,
    TILE_W,
    TriSetup,
    VisibilityBuffer,
    _finish_setup,
    _fma,
    bin_triangles,
    rasterize,
    rasterize_plain,
    setup_triangles,
)

W, H = 256, 192


def _random_setup(device, grid_height=None, grid_origin=(0, 0), copies=1):
    """Seeded clip-space triangles, some crossing the near plane (w < eps)
    so the clip fan's second slots are exercised; ``copies`` > 1 repeats
    them (coplanar duplicates under other slot ids: exact depth ties)."""
    rng = np.random.default_rng(17)
    xyz = rng.uniform([-1.3, -1.3, 0.05], [1.3, 1.3, 0.95], size=(48, 3, 3))
    w = rng.uniform(-0.2, 2.0, size=(48, 3, 1))
    clip = np.concatenate([xyz * np.abs(w), w], axis=-1).astype(np.float32)
    clip = np.concatenate([clip] * copies).reshape(-1, 4)
    n = clip.shape[0] // 3
    return setup_triangles(
        torch.from_numpy(clip).to(device),
        torch.arange(n * 3, dtype=torch.int32, device=device).reshape(n, 3),
        torch.ones(n, dtype=torch.bool, device=device), W, H, 0,
        grid_height=grid_height, grid_origin=grid_origin,
    )


def _dense_setup(device):
    """The dense sphere field (64 x sphere(8, 16)) seen by its camera."""
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import eulers_from_forward, matmul4
    from syzygy_tpu_torch.scene.pack import (
        pack_frame_params,
        pack_geometry,
        prepare_frame_state,
        upload_frame_params,
    )
    from syzygy_tpu_torch.scene.scene import dense_sphere_field

    scene, lib = dense_sphere_field(rings=8, segments=16)
    eye = torch.tensor([18.0, -16.0, -22.0])
    scene.camera.position = tuple(eye.tolist())
    scene.camera.euler_angles = tuple(
        eulers_from_forward(torch.tensor([0.0, -6.0, 0.0]) - eye).tolist()
    )
    geometry = pack_geometry(scene, lib, device)
    state = prepare_frame_state(upload_frame_params(pack_frame_params(scene, W / H), device))
    clip, _ = transform_positions(
        geometry.positions, geometry.vert_instance, state.models,
        matmul4(state.camera.projection, state.camera.view),
    )
    return setup_triangles(clip, geometry.triangles, geometry.tri_valid, W, H, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the raster kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["random", "dense"])
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_matches_plain(cuda, scene, depth_only):
    """Bitwise: the kernel and the plain version run the same plane
    arithmetic (fmas at the same places) in the same depth order; one
    launch is counted."""
    setup = _random_setup(cuda) if scene == "random" else _dense_setup(cuda)
    kind = "depth" if depth_only else "visibility"
    before = LAUNCHES[kind]
    kern = rasterize(setup, W, H, depth_only=depth_only)
    assert LAUNCHES[kind] == before + 1
    plain = rasterize_plain(setup, W, H, depth_only=depth_only)
    torch.cuda.synchronize()
    fields = ("depth",) if depth_only else ("depth", "tri", "b0", "b1")
    for name in fields:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert (kern.depth > 0).any()


def _check_row_block(device):
    """Rows [64, 128) rastered as a block at global origin (64, 0) equal
    those rows of the whole frame: the affine forms are global, only the
    tile ranges depend on the origin."""
    full = rasterize(_random_setup(device), W, H)
    block_setup = _random_setup(device, grid_height=64, grid_origin=(64, 0))
    part = rasterize(block_setup, W, 64, origin=(64, 0))
    for name in ("depth", "tri", "b0", "b1"):
        assert torch.equal(getattr(part, name), getattr(full, name)[64:128]), name
    assert (part.tri >= 0).any()


@pytest.mark.cuda
def test_kernel_row_block_origin(cuda):
    _check_row_block(cuda)


def test_plain_row_block_origin():
    _check_row_block(torch.device("cpu"))


_FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
  case "$a" in
    *gather.cu) src=gather ;; *raster.cu) src=raster ;; *stamp.cu) src=stamp ;; *lighting.cu) src=lighting ;;
    *scattering.cu) src=scattering ;;
  esac
done
echo "$src" >> "$CALLS"
if [ "$src" = "$FAIL_ON" ]; then echo "error: refused" >&2; exit 2; fi
echo binary > "$out"
echo "ptxas info    : Used 32 registers" >&2
"""


def test_build_compiles_each_source_once(tmp_path, monkeypatch):
    """``kernels/build.py`` with a stand-in compiler: one nvcc per missing
    source, each library and its ptxas log under a content-hash name, no
    rebuild when present, and no partial file left when a compile fails."""
    from syzygy_tpu_torch.kernels import build

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "nvcc").write_text(_FAKE_NVCC)
    (bin_dir / "nvcc").chmod(0o755)
    calls = tmp_path / "calls"
    monkeypatch.setenv("PATH", f"{bin_dir}:{__import__('os').environ['PATH']}")
    monkeypatch.setenv("CALLS", str(calls))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))

    paths = build.build()
    assert sorted(paths) == sorted(build.SOURCES)
    assert sorted(calls.read_text().split()) == sorted(build.SOURCES)
    for name, path in paths.items():
        assert path == build.library_path(name) and (tmp_path / "build" / path.split("/")[-1]).exists()
        assert "registers" in build.ptxas_report(name)
    build.build()  # everything present: no compiler runs
    assert len(calls.read_text().split()) == len(build.SOURCES)

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build2"))
    monkeypatch.setenv("FAIL_ON", "gather")
    with pytest.raises(RuntimeError, match="csrc/gather.cu"):
        build.build()
    built = sorted(p.name.split("_")[1] for p in (tmp_path / "build2").iterdir())
    assert built == ["lighting", "lighting", "raster", "raster", "scattering", "scattering", "stamp", "stamp"]


def test_load_binds_entry_points_once(monkeypatch):
    """``build.load`` sets every entry point's argtypes/restype when it
    first loads a library, so a launch binds nothing."""
    from syzygy_tpu_torch.kernels import build

    class Lib:
        def __init__(self, path):
            self.path = path
            for entry in ("szg_raster", "szg_lane_gather", "szg_stamp", "szg_capture_nodes", "szg_lighting",
                          "szg_scattering"):
                setattr(self, entry, type("Fn", (), {})())

    monkeypatch.setattr(build, "build", lambda name: {name: f"/lib/{name}.so"})
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    monkeypatch.setattr(build, "_loaded", {})
    for name, entries in build.ENTRY_POINTS.items():
        lib = build.load(name)
        assert build.load(name) is lib
        for entry, (argtypes, restype) in entries.items():
            fn = getattr(lib, entry)
            assert fn.argtypes == argtypes and fn.restype is restype
    # pointers and the stream travel as c_void_p, never as a 32-bit int
    raster_args, _ = build.ENTRY_POINTS["raster"]["szg_raster"]
    assert raster_args.count(ctypes.c_void_p) == 10 and len(raster_args) == 18
    gather_args, _ = build.ENTRY_POINTS["gather"]["szg_lane_gather"]
    assert gather_args.count(ctypes.c_void_p) == 4 and gather_args.count(ctypes.c_longlong) == 2
    stamp_args, _ = build.ENTRY_POINTS["stamp"]["szg_stamp"]
    assert stamp_args.count(ctypes.c_void_p) == 3 and len(stamp_args) == 8
    assert build.ENTRY_POINTS["stamp"]["szg_capture_nodes"][0] == [ctypes.c_void_p] * 2
    lighting_args, _ = build.ENTRY_POINTS["lighting"]["szg_lighting"]
    assert lighting_args.count(ctypes.c_void_p) == 18 and lighting_args.count(ctypes.c_longlong) == 1
    assert len(lighting_args) == 26
    scattering_args, _ = build.ENTRY_POINTS["scattering"]["szg_scattering"]
    assert scattering_args.count(ctypes.c_void_p) == 8 and scattering_args.count(ctypes.c_longlong) == 1
    assert len(scattering_args) == 14


# --- the kernel's design rules, on the CPU ----------------------------------
#
# csrc/raster.cu tests a slot only inside its pixel_box (clipped to the
# tile) and merges hits order-free as keys (bits(z) << 32) | (slot + 1).
# The setups below are the cases both rules are held to here and the kernel
# is held to on the card.


def _look(scene, eye, target):
    from syzygy_tpu_torch.math.geometry import eulers_from_forward

    eye = torch.tensor(eye)
    scene.camera.position = tuple(eye.tolist())
    scene.camera.euler_angles = tuple(eulers_from_forward(torch.tensor(target) - eye).tolist())


@functools.lru_cache(maxsize=None)
def _scene_setups(name):
    """The camera and sun-shadow setups a frame of scene ``name`` builds
    (``renderer/frame.py``) at test size, on the CPU."""
    from syzygy_tpu_torch.assets.chess import flagship_scene
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4, matvec
    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.pack import (
        pack_frame_params,
        pack_geometry,
        prepare_frame_state,
        upload_frame_params,
    )
    from syzygy_tpu_torch.scene.scene import default_scene, dense_sphere_field

    if name == "default":
        scene, library = default_scene()
        scene.sun_animation.time = 0.35  # daylight: the sun casts shadows
        scene.sun_animation.frozen = True
        scene.tick(0.0)
        config = RenderConfig(width=256, height=128, shadow_dim=1024)  # the cubes' shadows: 12 texels
    elif name == "dense":
        scene, library = dense_sphere_field(rings=8, segments=16)
        _look(scene, (18.0, -16.0, -22.0), (0.0, -6.0, 0.0))
        config = RenderConfig(width=256, height=192, shadow_dim=256)
    else:
        scene, library = flagship_scene()
        scene.tick(0.0)
        _look(scene, (13.0, -8.0, -14.0), (0.0, -1.0, 0.0))
        config = RenderConfig(width=256, height=144, shadow_dim=256)
    geometry = pack_geometry(scene, library, "cpu")
    state = prepare_frame_state(upload_frame_params(pack_frame_params(scene, config.width / config.height), "cpu"))
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models,
        matmul4(state.camera.projection, state.camera.view),
    )
    camera = setup_triangles(
        clip, geometry.triangles, geometry.tri_valid, config.render_width, config.render_height, 1,
        grid_width=config.padded_width, grid_height=config.padded_height,
    )
    sun = state.directional_lights
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    dim = config.shadow_dim
    shadow = setup_triangles(
        None, geometry.triangles, geometry.tri_valid & geometry.tri_casts_shadow, dim, dim, -1,
        corner_clip=matvec(matmul4(sun.projection[0], sun.view[0]), world_h[geometry.triangles.long()]),
        depth_bias_constant=config.shadow_bias_constant, depth_bias_slope=config.shadow_bias_slope,
    )
    return {
        "camera": (camera, config.padded_width, config.padded_height, (0, 0)),
        "sun": (shadow, dim, dim, (0, 0)),
    }


def _screen_setup(corners, z):
    """Setup of screen-space triangles (corners (n, 3, 2) in pixels, depth
    z (n, 3)) on the W x H target, w = 1 (no near clip, no cull)."""
    corners = np.asarray(corners, np.float64)
    ndc = np.concatenate([corners / [W, H] * 2.0 - 1.0, np.asarray(z, np.float64)[..., None]], axis=-1)
    clip = np.concatenate([ndc, np.ones(ndc.shape[:-1] + (1,))], axis=-1).astype(np.float32)
    n = clip.shape[0]
    return setup_triangles(
        torch.from_numpy(clip.reshape(-1, 4)), torch.arange(n * 3, dtype=torch.int32).reshape(n, 3),
        torch.ones(n, dtype=torch.bool), W, H, 0,
    )


def _with_depth(setup, slots, z2, dz0, dz1):
    """``setup`` with the depth forms of ``slots`` replaced."""
    coeffs = setup.coeffs.clone()
    coeffs[slots, 6], coeffs[slots, 7], coeffs[slots, 8] = z2, dz0, dz1
    return setup._replace(coeffs=coeffs)


def _signed_zero_setup():
    """Two pairs of coplanar triangles at depth 0, one of each pair built
    with z = -0.0 (z2 = dz0 = dz1 = -0.0): -0.0 passes ``z >= 0`` and ties
    with +0.0, so the larger slot of each pair must win."""
    tri_a = [[20.0, 20.0], [120.0, 30.0], [40.0, 150.0]]
    tri_b = [[130.0, 40.0], [250.0, 20.0], [200.0, 170.0]]
    setup = _screen_setup([tri_a, tri_a, tri_b, tri_b], np.full((4, 3), 0.5))
    setup = _with_depth(setup, [0, 3], 0.0, 0.0, 0.0)
    return _with_depth(setup, [1, 2], -0.0, -0.0, -0.0)


def _sliver_setup():
    """One valid sliver slot whose doubled area is 2e-12 (just above the
    setup's 1e-12 validity cut), its f32 coefficient row built from exact
    corners as ``_setup_slots`` builds rows, beside an ordinary triangle.
    Its forms have coefficients near 1e13, so their f32 evaluation can
    pass the hit test far from the corners."""
    x0, y0, x1, y1 = 0.5, 0.5, 60.5, 30.5
    x2, y2 = 30.5, 15.5 + 2e-12 / 60.0  # area2 = 60 * (y2 - 15.5)
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    inv = 1.0 / area2
    sliver = [
        ((y2 - y1) * x1 - (x2 - x1) * y1) * inv, -(y2 - y1) * inv, (x2 - x1) * inv,
        ((y0 - y2) * x2 - (x0 - x2) * y2) * inv, -(y0 - y2) * inv, (x0 - x2) * inv,
        0.5, 0.0, 0.0, 1.0, x0, x1, y0, y1,
    ]
    inf = float("inf")
    invalid = [0.0] * 10 + [inf, -inf, inf, -inf]
    cols = torch.tensor([sliver, invalid], dtype=torch.float64).float()
    ordinary = _screen_setup([[[30.0, 150.0], [90.0, 120.0], [60.0, 185.0]]], [[0.3, 0.3, 0.3]])
    setup = _finish_setup(cols, torch.zeros((2, 3, 2)), torch.ones((2, 3)), W, H, (0, 0))
    both = [torch.cat([a[:2], b[:2], a[2:]]) for a, b in zip(setup, ordinary)]
    return TriSetup(*both)._replace(orig_tri=torch.tensor([0, 1, 2, 3] + [0] * (both[1].numel() - 4), dtype=torch.int32))


def _split_setup():
    """4,000 small triangles inside tile (0, 0), half of them coplanar
    duplicates: one tile list long enough to be cut into the kernel's 8
    parts of 2 batches each."""
    rng = np.random.default_rng(23)
    centre = rng.uniform([4.0, 4.0], [TILE_W - 4.0, TILE_H - 4.0], size=(2000, 1, 2))
    corners = centre + rng.uniform(-3.0, 3.0, size=(2000, 3, 2))
    z = rng.uniform(0.05, 0.95, size=(2000, 3))
    return _screen_setup(np.concatenate([corners, corners]), np.concatenate([z, z]))


def _setup(case):
    """(setup, width, height, origin) of a named case, on the CPU."""
    if case == "random":
        return _random_setup("cpu"), W, H, (0, 0)
    if case == "random_block":
        return _random_setup("cpu", grid_height=64, grid_origin=(64, 0)), W, 64, (64, 0)
    if case == "random_ties":
        return _random_setup("cpu", copies=2), W, H, (0, 0)
    if case == "signed_zero":
        return _signed_zero_setup(), W, H, (0, 0)
    if case == "sliver":
        return _sliver_setup(), W, H, (0, 0)
    if case == "split":
        return _split_setup(), W, H, (0, 0)
    scene, kind = case.split("_")
    return _scene_setups(scene)[kind]


SCENE_CASES = [f"{s}_{k}" for s in ("default", "dense", "flagship") for k in ("camera", "sun")]
CASES = ["random", "random_block", "random_ties", "signed_zero", "sliver", "split"] + SCENE_CASES


def _plane(c, x, y):
    """The kernel's forms of coefficient rows ``c`` at global pixels (x, y)."""
    px, py = x.float() + 0.5, y.float() + 0.5
    e0 = _fma(c[:, 1], px, c[:, 0]) + c[:, 2] * py
    e1 = _fma(c[:, 4], px, c[:, 3]) + c[:, 5] * py
    return e0, e1, _fma(c[:, 8], e1, _fma(c[:, 7], e0, c[:, 6]))


def _hit(c, e0, e1, z):
    return (e0 >= 0) & (e1 >= 0) & ((1.0 - e0) - e1 >= 0) & (z <= 1.0) & (z >= 0.0) & (c[:, 9] > 0)


def _listed(lists):
    """The list entries, without the padding past ``offsets[-1]``."""
    return lists.slots[: int(lists.offsets[-1])]


def _pairs(lists):
    """The tile of every list entry."""
    off = lists.offsets.long()
    return torch.repeat_interleave(torch.arange(off.numel() - 1), off[1:] - off[:-1])


def _whole_tile_hits(setup, lists, origin):
    """(slot, y, x), target-local, of every pixel of every listed (tile,
    slot) pair where the f32 hit test passes: the whole-tile evaluation
    of the reference and of ``rasterize_plain``."""
    tiles = _pairs(lists)
    ys, xs = torch.meshgrid(torch.arange(TILE_H), torch.arange(TILE_W), indexing="ij")
    found = []
    for start in range(0, tiles.numel(), 128):
        slot = _listed(lists)[start : start + 128].long()
        t = tiles[start : start + 128]
        y = ((t // lists.tiles_x) * TILE_H)[:, None] + ys.reshape(1, -1)
        x = ((t % lists.tiles_x) * TILE_W)[:, None] + xs.reshape(1, -1)
        c = setup.coeffs[slot]
        e0, e1, z = _plane(c[:, :, None], x + origin[1], y + origin[0])
        pair, px = torch.nonzero(_hit(c[:, :, None], e0, e1, z), as_tuple=True)
        found.append(torch.stack([slot[pair], y[pair, px], x[pair, px]], dim=1))
    return torch.cat(found)


def _clipped_boxes(setup, lists):
    """Every list entry's pixel box clipped to its tile: (x0, x1, y0, y1)."""
    tiles = _pairs(lists)
    ty, tx = tiles // lists.tiles_x, tiles % lists.tiles_x
    b = setup.pixel_box[_listed(lists).long()].long()
    return (
        torch.maximum(b[:, 0], tx * TILE_W), torch.minimum(b[:, 1], tx * TILE_W + TILE_W - 1),
        torch.maximum(b[:, 2], ty * TILE_H), torch.minimum(b[:, 3], ty * TILE_H + TILE_H - 1),
    )


@pytest.mark.parametrize("case", CASES)
def test_pixel_boxes_hold_every_hit(case):
    """Tolerance: exact. Over every pixel of every listed (tile, slot) pair,
    each pixel where the f32 hit test passes lies inside the slot's
    pixel_box, so testing the box alone loses no hit; and the boxes cut the
    pixels tested below the whole tiles."""
    setup, w, h, origin = _setup(case)
    lists = bin_triangles(setup.coeffs, h, w)
    hits = _whole_tile_hits(setup, lists, origin)
    assert hits.shape[0] > 0
    box = setup.pixel_box[hits[:, 0]].long()
    y, x = hits[:, 1], hits[:, 2]
    inside = (x >= box[:, 0]) & (x <= box[:, 1]) & (y >= box[:, 2]) & (y <= box[:, 3])
    assert bool(inside.all()), f"{int((~inside).sum())} hits outside their slot's box"
    x0, x1, y0, y1 = _clipped_boxes(setup, lists)
    tested = int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)).sum())
    assert tested < _listed(lists).numel() * TILE_H * TILE_W


def test_sliver_takes_the_whole_tile_path():
    """A valid sliver (|area2| = 2e-12) cannot be bounded tightly: its box
    is the whole target, so the kernel tests every pixel of its listed
    tiles, as the reference does; its f32 test does pass outside its
    corners' bounding box, which is why a box from the corners alone would
    lose hits. The ordinary triangle beside it keeps a tight box."""
    setup, w, h, origin = _setup("sliver")
    assert setup.coeffs[0, 9] > 0 and setup.coeffs[0, :6].abs().max() > 1e12
    assert setup.pixel_box[0].tolist() == [0, w - 1, 0, h - 1]
    ordinary = setup.pixel_box[2].tolist()
    assert 0 < ordinary[1] - ordinary[0] < 70 and 0 < ordinary[3] - ordinary[2] < 70
    hits = _whole_tile_hits(setup, bin_triangles(setup.coeffs, h, w), origin)
    sliver = hits[hits[:, 0] == 0]
    x, y = sliver[:, 2].double() + 0.5, sliver[:, 1].double() + 0.5
    c = setup.coeffs[0].double()
    outside = (x < 0.5) | (x > 60.5) | (y < 0.5) | (y > 30.5)
    assert sliver.shape[0] > 0 and bool(outside.any())
    assert c[10] == 1 and c[11] == 1  # listed on tile (0, 0) alone


NEGATIVE_ZERO = -(2**31)  # the bits of -0.0 as int32


def _assert_raster_bits(out, plain, depth_only):
    """Every field bitwise (as int32 bits, so -0.0 differs from +0.0),
    but that a depth-only raster writes +0.0 where the serial loop commits
    a hit at -0.0: its merged depth bits carry no slot to recompute z
    from (``csrc/raster.cu``), so it is equal there in value, not in bits."""
    if depth_only:
        want = plain.depth.view(torch.int32)
        want = torch.where(want == NEGATIVE_ZERO, torch.zeros_like(want), want)
        assert torch.equal(out.depth.view(torch.int32), want), "depth"
        assert torch.equal(out.depth, plain.depth), "depth"
        return
    for name in ("depth", "tri", "b0", "b1"):
        assert torch.equal(getattr(out, name).view(torch.int32), getattr(plain, name).view(torch.int32)), name


def _key_merge(setup, lists, w, h, depth_only, origin, seed):
    """A plain model of the kernel's order-free merge: the list entries in
    a shuffled order, in parts; each tested over its pixel box clipped to
    its tile; a hit is the key (bits(z + 0.0) << 32) | (slot + 1) (the
    bits alone for depth only; + 0.0 turns -0.0 into +0.0) and keys merge
    by max; the winner's forms are recomputed at the pixel."""
    oy, ox = origin
    x0, x1, y0, y1 = _clipped_boxes(setup, lists)
    bw, bh = (x1 - x0 + 1).clamp(min=0), (y1 - y0 + 1).clamp(min=0)
    order = torch.randperm(_listed(lists).numel(), generator=torch.Generator().manual_seed(seed))
    keys = torch.zeros(h * w, dtype=torch.int64)
    for part in order.split(97):
        area = bw[part] * bh[part]
        item = torch.repeat_interleave(torch.arange(part.numel()), area)
        r = torch.arange(int(area.sum())) - (torch.cumsum(area, 0) - area)[item]
        entry = part[item]
        x = x0[entry] + r % bw[entry]
        y = y0[entry] + r // bw[entry]
        slot = lists.slots[entry].long()
        c = setup.coeffs[slot]
        e0, e1, z = _plane(c, x + ox, y + oy)
        hit = _hit(c, e0, e1, z)
        zbits = (z + 0.0).view(torch.int32).long()
        key = zbits if depth_only else (zbits << 32) | (slot + 1)
        merged = torch.zeros(h * w, dtype=torch.int64).scatter_reduce_(0, (y * w + x)[hit], key[hit], "amax")
        keys = torch.maximum(keys, merged)
    if depth_only:
        depth = keys.to(torch.int32).view(torch.float32).reshape(h, w)
        empty = torch.zeros((0, 0))
        return VisibilityBuffer(depth, empty, empty, empty)
    winner = (keys & 0xFFFFFFFF) - 1
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    e0, e1, z = _plane(setup.coeffs[winner.clamp(min=0)], xs.reshape(-1) + ox, ys.reshape(-1) + oy)
    hit = keys > 0
    zero = torch.zeros_like(z)
    return VisibilityBuffer(
        torch.where(hit, z, zero).reshape(h, w), winner.to(torch.int32).reshape(h, w),
        torch.where(hit, e0, zero).reshape(h, w), torch.where(hit, e1, zero).reshape(h, w),
    )


@pytest.mark.parametrize("case", ["random_ties", "signed_zero", "split", "dense_camera", "flagship_camera", "flagship_sun"])
@pytest.mark.parametrize("depth_only", [False, True])
def test_key_merge_equals_serial_depth_test(case, depth_only):
    """Tolerance: exact (the bits of depth, ids and barycentrics; a
    depth-only raster's -0.0 as +0.0). The order-free key merge over a
    shuffled list equals ``rasterize_plain`` (the serial ``z >= depth``
    loop): coplanar duplicates go to the larger slot, and a hit at
    z = -0.0 ties with +0.0."""
    setup, w, h, origin = _setup(case)
    lists = bin_triangles(setup.coeffs, h, w)
    plain = rasterize_plain(setup, w, h, depth_only=depth_only, origin=origin, lists=lists)
    for seed in (0, 1):
        _assert_raster_bits(_key_merge(setup, lists, w, h, depth_only, origin, seed), plain, depth_only)
    assert bool((plain.depth > 0).any()) or case == "signed_zero"  # its hits lie at depth 0
    if case == "signed_zero":
        assert bool((plain.depth.view(torch.int32) == NEGATIVE_ZERO).any())
    if case == "signed_zero" and not depth_only:
        # the larger slot of each coplanar pair, where no other slot covers
        assert set(torch.unique(plain.tri).tolist()) == {-1, 1, 3}
        assert bool((plain.depth[plain.tri == 1].view(torch.int32) == NEGATIVE_ZERO).all())


def _on(setup, device):
    return TriSetup(*(t.to(device) for t in setup))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_matches_plain_cases(cuda, case, depth_only):
    """Bitwise (int32 bits; a depth-only raster's -0.0 as +0.0) on every
    case of the design rules: ties, -0.0, a sliver on the whole-tile path,
    a list cut into 8 parts, and the default, dense and flagship camera
    and sun setups."""
    setup, w, h, origin = _setup(case)
    setup = _on(setup, cuda)
    kern = rasterize(setup, w, h, depth_only=depth_only, origin=origin)
    plain = rasterize_plain(setup, w, h, depth_only=depth_only, origin=origin)
    torch.cuda.synchronize()
    _assert_raster_bits(kern, plain, depth_only)
    if case == "split":
        lists = bin_triangles(setup.coeffs, h, w)
        assert int(lists.offsets[1] - lists.offsets[0]) > 8 * 256  # 8 parts of 2 batches


@pytest.mark.parametrize("case", CASES)
def test_full_iteration_plain_equals_listed_plain(case):
    """Bitwise: ``rasterize_plain`` by full iteration (every slot whose
    tile range holds the tile: K3/K4's walk) equals it over the tile
    lists (K1/K2's), visibility and depth only, on every case."""
    setup, w, h, origin = _setup(case)
    for depth_only in (False, True):
        listed = rasterize_plain(setup, w, h, depth_only=depth_only, origin=origin)
        full = rasterize_plain(setup, w, h, depth_only=depth_only, origin=origin, full=True)
        for name in ("depth",) if depth_only else ("depth", "tri", "b0", "b1"):
            assert torch.equal(getattr(full, name).view(torch.int32), getattr(listed, name).view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_full_iteration_matches_plain(cuda, case, depth_only):
    """Bitwise (a depth-only raster's -0.0 as +0.0): the kernel by full
    iteration (``capacity=0``, counted as K3/K4) and over lists whose
    device overflow flag is set (capacity 1 where a tile lists more than
    64 slots, else forced) equals the plain version."""
    setup, w, h, origin = _setup(case)
    setup = _on(setup, cuda)
    plain = rasterize_plain(setup, w, h, depth_only=depth_only, origin=origin)
    kind = "depth_full" if depth_only else "visibility_full"
    before = LAUNCHES[kind]
    full = rasterize(setup, w, h, depth_only=depth_only, origin=origin, capacity=0)
    assert LAUNCHES[kind] == before + 1
    lists = bin_triangles(setup.coeffs, h, w, 1)
    forced = lists._replace(overflow=torch.ones((), dtype=torch.bool, device=cuda))
    overflowed = rasterize(setup, w, h, depth_only=depth_only, origin=origin, lists=forced)
    torch.cuda.synchronize()
    _assert_raster_bits(full, plain, depth_only)
    _assert_raster_bits(overflowed, plain, depth_only)
