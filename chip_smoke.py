#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``syzygy_tpu_torch/csrc/*.cu`` (the raster,
   the lighting, the in-scattering integral, the sky pass, the lane gather
   and the layer stamp, one ``nvcc`` each, concurrently), with ptxas's
   register report; then the C++ host core (``syzygy_tpu_torch/native.py``
   builds ``csrc/szg_native.cpp`` with ``g++``), which must load, and
   ``Scene.shadow_bounds`` through it on 40 seeded rotated-caster versions
   each of the default scene and the flagship, held against the numpy
   path at 1e-4;
3. each kernel vs its plain torch version on the card, bitwise, timed by
   CUDA events and on the device (``torch.profiler``), beside its bound:
   the raster on the default scene's 1920x1088 camera and 1024^2 sun map,
   the 254k-triangle dense sphere field's 960x544 camera and 1024^2 sun
   map, and the chess flagship's 1920x1088 camera and 1024^2 and 4096^2 sun
   maps, then
   two cases of the kernel's design at that scale (the flagship camera
   with every triangle twice: coplanar depth ties; 20,000 small triangles
   on 4 tiles: lists cut across a tile's 8 CTAs); the lane gather at
   S = 1,999,872 (the bench's default) and S = 33,554,432 (its indices and
   outputs exceed the L2) on the gather bench's seeded inputs, with
   ``torch.take`` as a yardstick;
   the flagship camera's rows [512, 1088) as a block at a non-zero origin,
   visibility and depth-only; the layer stamp on a ring of the main path's
   shape (4096 x 10) across its wrap, its sequence column and counter
   exactly ``stamp_plain``'s on a copy, its times in mark order, and a
   main path's parts (ten shadow slots' setup, binning and raster, the
   camera's four) captured in a graph of timed sleeps and replayed: each
   part's sum its sleeps', the parts' sum within their layers' stamps, the
   tile-list counters exact and the cells written a host trace's; the
   deferred lighting (``csrc/lighting.cu``) against
   ``deferred_lighting_plain`` at the cells' settings (1920x1088, 8192^2
   maps) on the default scene with its sun animated and the chess
   flagship, with all 2 + 16 light slots live, and the chess and
   all-slots cases again on ``pcf_q8`` maps of 2048 texels, each with the
   slots it evaluated, the kernel's device time and the whole call's,
   beside the plain version and its bytes bound; the in-scattering
   integral (``csrc/scattering.cu``) against its plain version on every
   integral a 1920x1080 frame calls (the editor's default scene: the
   sky-view rows and the aerial froxels; the chess flagship's quirk-exact
   frame: the sky-view rows, the per-pixel integral and the metallic
   bounce's), each with its launches, the kernel's device time, the whole
   call's, the plain version's and the operations bound; the LUT sky
   camera pass (``csrc/sky.cu``) against ``sky_camera_pass_lut_plain`` at
   the cells' settings (1920x1088, 8192^2 maps, q8 sky-view) on the
   editor's default scene (no metallic bounce) and the chess flagship (the
   bounce), each with the kernel's device time, the whole call's (the
   table's prologue included), the plain pass's and the bytes bound;
4. the main paths, each with its kernel launches counted from just before
   to just after (the stamps', the lighting's, the scattering's and the
   sky's too:
   each replay launches those its graph holds): 4 frames of the default scene and 3 of the chess
   flagship through ``renderer.frame.render_frame`` at the default
   1920x1080 RenderConfig (CUDA-event ms/frame, peak memory); the chess
   flagship at 1920x1080 in the quirk-exact configuration of
   ``tools/parity_1080p.py`` (``n_shadow_maps=4, aerial_lut=False,
   fast_sky_reflection=False``), 3 frames, held against
   ``tests/goldens/flagship_1080p.npz`` under that tool's verdict, then
   the same frame through ``render_frame_packed`` and as two row blocks
   of ``render_frame_rows``, bitwise ``render_frame``'s; ``bench.py``'s
   three scenes at 1920x1080 through ``render_frame_packed``, 8 replayed
   frames each after the capture, one camera raster a frame, each last
   frame bitwise a direct ``render_frame_packed`` of its row; and the
   port's gather bench (``tools/gather_bench.py``, g1-g7) at its default
   size; the frame without a host sync (``dispatch``): the default (sun
   animated), dense, flagship and quirk-exact 1080p frames under
   ``torch.cuda.set_sync_debug_mode("error")``, each replay from its CUDA
   graph bitwise the eager frame, after the row changes and across a
   config switch, and returned while its frame still runs; the host ms to
   enqueue a replay, capture seconds, graph pool bytes, peak memory, and
   the dense frame at 10 and 2 shadow-map slots (an idle slot's price);
   the full-iteration rasters (K3/K4) at ``tile_list_capacity=0`` and
   through a forced overflow flag, bitwise their plain versions; and, as
   its main path, flagship frames at capacity 0 and dense frames at
   capacity 1, bitwise the default frames;
5. parity at the golden configs, card against the CPU port and against
   the JAX package's goldens: the default scene at 256x128
   (``default_scene_256x128.png``) and the flagship at 512x288
   (``flagship_512x288.npz``, visibility ``flagship_vis_512x288.npz``);
   at that size also the mip-mapped resolve, the debug lines (with and
   without the atmosphere, and under supersample 2), the fast sky
   (with and without the aerial LUT), ``pcf_q8``, ``lut_f16``,
   ``share_sun_pcf`` and ``shadow_dim=4096``,
   card against the CPU port, each case's card ms/frame printed; for the
   plain and the 4096 case the sun's shadow lookup card against CPU stage
   by stage (visibility, G-buffer position and normal, shadow
   coordinates, PCF factors and their taps; the card's shadow frame and
   taps must be what the CPU's code makes of the card's inputs), and two
   roundings on each device (``torch.sum``'s order over 3 terms, the
   PCF's division by 25);
6. the app and the viewer, each a main path with its launches counted
   from just before to just after: ``python -m
   syzygy_tpu_torch.app``'s ``main`` on the chess flagship at 1920x1080
   (4 orbiting frames, an input script, ``--set`` of a scene property
   and a config field, ``--save-scene``; ``--list-properties`` prints the
   table), its last frame bitwise a direct ``render_frame_packed`` of the
   saved scene; and the interactive viewer (``app.serve.serve``) on the
   flagship at the default 1920x1080 RenderConfig, driven over
   127.0.0.1 through a fixed script of fly input, preview and refined
   frames, property edits (one refused with a 4xx), the texture
   inspector and two scene loads, its final frame bitwise a direct
   render of its state, every rendered request through the camera
   raster; then what two frames in flight save per request;
7. multi-device rendering (``parallel/sharding.py``), each case a main
   path with rank 0's launch counts, each batch bitwise the direct
   ``render_frame``: world size 1 in this process on the flagship at
   1920x1080, then two spawned gloo ranks sharing the card at (dp=1,
   sp=2) on the flagship and at (2, 1) on two default-scene frames.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations


import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
GOLDEN = os.path.join(GOLDEN_DIR, "default_scene_256x128.png")
FLAGSHIP_FRAME = os.path.join(GOLDEN_DIR, "flagship_512x288.npz")
FLAGSHIP_VIS = os.path.join(GOLDEN_DIR, "flagship_vis_512x288.npz")
FLAGSHIP_1080P = os.path.join(GOLDEN_DIR, "flagship_1080p.npz")  # tools/parity_1080p.py gen
# tools/parity_1080p.py:51-57 and its verdict (:98-125)
EXACT_CONFIG = dict(width=1920, height=1080, n_shadow_maps=4, aerial_lut=False, fast_sky_reflection=False)
# The golden was rendered on 2026-08-16 (d68bcb7), before the JAX package
# made f16 PCF tables and an f16 atlas (57504bf), the q8 sky-view (21abec2)
# and the dim-light shadow skip (c8a2d66) its defaults: it holds f32 storage
# throughout. The f16 PCF alone moves the self-shadowing pattern on the
# pieces' lit sides by more than 0.01 at some 11,000 pixels, so the frame
# that is held against the golden pins the storage of the golden's date.
# tests/test_torch_golden_storage.py::test_reference_leaves_its_f32_frame_under_todays_storage
# shows the JAX package's own frame moving the same way (0.52% of the pixels
# at 256x144) and the port following it under either storage.
GOLDEN_STORAGE = dict(pcf_f16=False, skyview_q8=False, skyview_f16=False, shadowless_strength_eps=0.0)
PARITY_OUTLIER, PARITY_RMSE, PARITY_OUTLIER_SHARE = 0.01, 1e-3, 10_000
ROW_SPLIT = 512  # the row blocks [0, 512) and [512, 1088) of the 1088-row padded target

# published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# csrc/raster.cu per (pixel, slot): 2 mul + 4 add/sub + 2 fma (2 each) + 6 compares
RASTER_OPS_PER_TEST = 16
REPS = 20
FEATURE_REPS = 3  # timed card frames per feature case
TRACE_ATTEMPTS = 3  # device_ms's traces before it gives up
GATHER_SIZES = (1_999_872, 33_554_432)  # the bench's default S; 2^25 (268 MB of idx + out)
NATIVE_SEEDS = 40  # rotated-caster scenes per scene in phase_native
SHARDED_TIMEOUT = 300.0  # s: the world-size-1 group, and the spawned ranks of both gloo cases
SHARDED_DEFAULT_DT = 20.0  # s between the (2, 1) case's two default-scene frames

# the visibility class of the golden comparison (tests/test_raster.py rules)
EDGE_TOL = 1e-4  # an id may differ only this close (barycentric) to an edge


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the HBM rate or
    operations over the fp32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = REPS) -> float:
    """Mean CUDA-event ms of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = REPS, kernel: str | None = None) -> float:
    """Mean summed device time (ms) of the kernels ``fn`` launches, from
    ``torch.profiler``'s CUDA activity over ``reps`` calls: the kernels
    alone, without the host's time between launches; with ``kernel``,
    only those whose name holds it. A trace that comes back without such
    kernel events (the tracer dropped them) is taken again, up to
    ``TRACE_ATTEMPTS`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and (kernel is None or kernel in e.name)]
        if kernels:
            return sum(e.time_range.elapsed_us() for e in kernels) / 1000.0 / reps
    raise SmokeFailure(f"the profiler saw no kernel in {TRACE_ATTEMPTS} traces")


def default_scene_config(scene, library, **overrides):
    import dataclasses

    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.pack import scene_uses_metallic

    config = RenderConfig(**overrides)
    return dataclasses.replace(
        config, metallic_reflection=scene_uses_metallic(scene, library)
    )


def flagship():
    """The chess flagship through the port's glTF path, framed as
    ``bench.py`` frames it (``bench.py:260-271``)."""
    from syzygy_tpu_torch.bench import chess_scene

    return chess_scene()


def setup_with_screen(corners, valid, width, height, cull, **grid):
    """A triangle setup and its slots' screen boxes (the corners' bounding
    boxes, ``_setup_slots`` columns 9-13: valid, min/max x, min/max y),
    which the setup does not keep; the raster's bound counts them."""
    from syzygy_tpu_torch.kernels.raster import _setup_slots, setup_triangles

    setup = setup_triangles(None, None, valid, width, height, cull, corner_clip=corners, **grid)
    return setup, _setup_slots(corners, valid, width, height, cull)[0][:, 9:14]


def raster_setups(geometry, params, config, copies=1, row0=0, local_rows=None):
    """The camera and sun-shadow triangle setups exactly as the frame
    builds them, each with its screen boxes; ``copies`` > 1 repeats every
    triangle (coplanar duplicates under other slot ids); ``row0`` and
    ``local_rows`` give the camera's row block, as ``render_frame_rows``
    sets it up."""
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4, matvec
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    state = prepare_frame_state(params)
    cam = state.camera
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, matmul4(cam.projection, cam.view)
    )
    tris = geometry.triangles.long().repeat(copies, 1)
    camera = setup_with_screen(
        clip[tris], geometry.tri_valid.repeat(copies), config.render_width, config.render_height, 1,
        grid_width=config.padded_width,
        grid_height=config.padded_height if local_rows is None else local_rows, grid_origin=(row0, 0),
    )
    sun = state.directional_lights
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    shadow = setup_with_screen(
        matvec(matmul4(sun.projection[0], sun.view[0]), world_h[tris]),
        (geometry.tri_valid & geometry.tri_casts_shadow).repeat(copies),
        config.shadow_dim, config.shadow_dim, -1,
    )
    return camera, shadow


def split_case(device, width=1920, height=1088):
    """20,000 small seeded triangles on the 4 tiles of the target's top-left
    256x128 px, every one twice (coplanar duplicates): lists of ~5,000
    pairs per tile, which the kernel cuts into 8 parts of 3 batches."""
    import numpy as np

    rng = np.random.default_rng(29)
    centre = rng.uniform([4.0, 4.0], [252.0, 124.0], size=(10_000, 1, 2))
    corners = np.concatenate([centre + rng.uniform(-3.0, 3.0, size=(10_000, 3, 2))] * 2)
    z = np.concatenate([rng.uniform(0.05, 0.95, size=(10_000, 3))] * 2)
    ndc = np.concatenate([corners / [width, height] * 2.0 - 1.0, z[..., None], np.ones_like(z[..., None])], axis=-1)
    clip = torch.from_numpy(ndc.astype(np.float32)).to(device)
    return setup_with_screen(clip, torch.ones(clip.shape[0], dtype=torch.bool, device=device), width, height, 0)


def edge_distance(setup, ys, xs, ids) -> float:
    """Largest barycentric distance to an edge of slot ``ids`` at pixel
    centres (xs, ys) (0 where the id is background)."""
    px = xs.double() + 0.5
    py = ys.double() + 0.5
    c = setup.coeffs[ids.clamp(min=0).long()].double()
    b0 = c[:, 0] + c[:, 1] * px + c[:, 2] * py
    b1 = c[:, 3] + c[:, 4] * px + c[:, 5] * py
    edge = torch.minimum(torch.minimum(b0.abs(), b1.abs()), (1 - b0 - b1).abs())
    return float(torch.where(ids >= 0, edge, torch.zeros_like(edge)).max()) if ids.numel() else 0.0


def screen_tests(screen, height, width, row0=0) -> int:
    """Pixel centres inside each valid slot's screen box, clipped to the
    target (rows ``[row0, row0 + height)`` of the screen): the tests a
    raster needs."""
    def centres(lo, hi, first_px, n):
        first = torch.ceil(torch.clamp(lo.double(), min=first_px + 0.5) - 0.5)
        last = torch.floor(torch.clamp(hi.double(), max=first_px + n - 0.5) - 0.5)
        return (last - first + 1).clamp(min=0)

    valid = screen[:, 0] > 0
    count = centres(screen[:, 1], screen[:, 2], 0, width) * centres(screen[:, 3], screen[:, 4], row0, height)
    return int(count[valid].sum())


def raster_bound(lists, screen, height, width, depth_only, row0=0) -> dict:
    """Bytes: each listed slot's 12-float row, each list entry and offset,
    and the outputs (4 B/px depth; 16 B/px visibility) once. Operations:
    16 per pixel centre inside each valid slot's screen box, clipped to the
    target (``bound_ms``); the old count, 16 per pixel of every listed
    (tile, slot) pair, the work of the whole-tile design, stays beside it
    (``bound_old_ms``)."""
    from syzygy_tpu_torch.kernels.raster import TILE_H, TILE_W

    pairs = int(lists.offsets[-1])
    listed = int(torch.unique(lists.slots[:pairs]).numel()) if pairs else 0
    n_bytes = listed * 48 + pairs * 4 + int(lists.offsets.numel()) * 4 + height * width * (4 if depth_only else 16)
    tests = screen_tests(screen, height, width, row0)
    out = {"screen_tests": tests}
    out["bound_ms"], out["bound_by"] = bound(n_bytes, tests * RASTER_OPS_PER_TEST)
    out["bound_old_ms"], out["bound_old_by"] = bound(n_bytes, pairs * TILE_H * TILE_W * RASTER_OPS_PER_TEST)
    return out


def compare_raster(name, setup_screen, width, height, depth_only, row0=0):
    """Kernel vs rasterize_plain on the same inputs, bitwise (``torch.equal``
    on every field); ``row0`` is the target's first row on the screen (the
    kernel's origin operand); returns a report."""
    from syzygy_tpu_torch.kernels import raster

    setup, screen = setup_screen
    origin = (row0, 0)
    lists = raster.bin_triangles(setup.coeffs, height, width)
    kern = raster.rasterize(setup, width, height, depth_only=depth_only, origin=origin, lists=lists)
    torch.cuda.synchronize()
    plain = raster.rasterize_plain(setup, width, height, depth_only=depth_only, origin=origin, lists=lists)
    torch.cuda.synchronize()

    report = {"name": name, "shape": [height, width], "origin": list(origin), "pairs": int(lists.offsets[-1])}
    fields = ("depth",) if depth_only else ("depth", "b0", "b1")
    err = max(float((getattr(kern, f) - getattr(plain, f)).abs().max()) for f in fields)
    report["max_abs_err"] = err
    if depth_only:
        report["covered_px"] = int((kern.depth > 0).sum())
    else:
        report["id_flips"] = int((kern.tri != plain.tri).sum())
        report["covered_px"] = int((kern.tri >= 0).sum())
        check(report["id_flips"] == 0, f"{name}: {report['id_flips']} ids differ from the plain version")
    check(err == 0.0 and all(torch.equal(getattr(kern, f), getattr(plain, f)) for f in fields),
          f"{name}: depth/barycentrics differ from the plain version by {err}")

    # the kernel alone (lists prebuilt) and the plain version
    def launch():
        return raster.rasterize(setup, width, height, depth_only=depth_only, origin=origin, lists=lists)

    report["ms"] = time_ms(launch)
    report["device_ms"] = device_ms(launch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    raster.rasterize_plain(setup, width, height, depth_only=depth_only, origin=origin, lists=lists)
    end.record()
    torch.cuda.synchronize()
    report["plain_ms"] = start.elapsed_time(end)
    report.update(raster_bound(lists, screen, height, width, depth_only, row0))
    report["library_ms"] = None  # no single PyTorch call computes a raster
    print("compare " + json.dumps(report), flush=True)
    return report


def compare_full(name, setup_screen, width, height, depth_only):
    """The full-iteration raster (K3/K4) vs ``rasterize_plain(full=True)``
    on the same inputs, bitwise: launched at ``capacity=0`` and as a
    listed launch whose device overflow flag is set (lists of capacity 1,
    the flag forced); timed like :func:`compare_raster`. Its bound: every
    slot's 12-float row and pixel box read once, the outputs written once,
    and the operations of the screen tests its slots need."""
    from syzygy_tpu_torch.kernels import raster

    setup, screen = setup_screen
    full = raster.rasterize(setup, width, height, depth_only=depth_only, capacity=0)
    lists = raster.bin_triangles(setup.coeffs, height, width, 1)
    forced = lists._replace(overflow=torch.ones((), dtype=torch.bool, device=setup.coeffs.device))
    overflowed = raster.rasterize(setup, width, height, depth_only=depth_only, lists=forced)
    torch.cuda.synchronize()
    plain = raster.rasterize_plain(setup, width, height, depth_only=depth_only, full=True)
    torch.cuda.synchronize()
    fields = ("depth",) if depth_only else ("depth", "tri", "b0", "b1")
    err = max(float((getattr(out, f) - getattr(plain, f)).abs().max()) for out in (full, overflowed) for f in fields)
    report = {"name": name, "shape": [height, width], "slots": int(setup.coeffs.shape[0]), "max_abs_err": err,
              "lists_overflowed_at_capacity_1": bool(lists.overflow)}
    check(err == 0.0 and all(torch.equal(getattr(out, f), getattr(plain, f)) for out in (full, overflowed) for f in fields),
          f"{name}: the full-iteration raster differs from the plain version by {err}")

    def launch():
        return raster.rasterize(setup, width, height, depth_only=depth_only, capacity=0)

    report["ms"] = time_ms(launch)
    report["device_ms"] = device_ms(launch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    raster.rasterize_plain(setup, width, height, depth_only=depth_only, full=True)
    end.record()
    torch.cuda.synchronize()
    report["plain_ms"] = start.elapsed_time(end)
    n_bytes = setup.coeffs.shape[0] * (48 + 16) + height * width * (4 if depth_only else 16)
    report["screen_tests"] = screen_tests(screen, height, width)
    report["bound_ms"], report["bound_by"] = bound(n_bytes, report["screen_tests"] * RASTER_OPS_PER_TEST)
    report["library_ms"] = None
    print("compare_full " + json.dumps(report), flush=True)
    return report


def phase_compare_raster(device):
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from syzygy_tpu_torch.bench import dense_scene
    from syzygy_tpu_torch.scene.scene import default_scene

    def both(prefix, scene, library, **overrides):
        config = default_scene_config(scene, library, **overrides)
        geometry = pack_geometry(scene, library, device)
        params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
        camera, shadow = raster_setups(geometry, params, config)
        return geometry, [
            compare_raster(f"{prefix}_camera", camera, config.padded_width, config.padded_height, False),
            compare_raster(f"{prefix}_sun_shadow", shadow, config.shadow_dim, config.shadow_dim, True),
        ]

    scene, library = default_scene()
    scene.tick(0.0)
    _, reports = both("default", scene, library)

    dense, dense_lib = dense_scene()
    dgeometry, dense_reports = both("dense", dense, dense_lib, width=960, height=544)
    check(int(dgeometry.tri_valid.sum()) == 253_952, "dense field is not 253,952 triangles")

    chess, chess_lib = flagship()
    fgeometry, flagship_reports = both("flagship", chess, chess_lib)
    check(int(fgeometry.tri_valid.sum()) == 14_316, "the flagship is not 14,316 triangles")
    # the largest map a config of the feature frames asks for (shadow_dim=4096)
    big = default_scene_config(chess, chess_lib, shadow_dim=4096)
    params = upload_frame_params(pack_frame_params(chess, big.width / big.height), device)
    flagship_reports.append(
        compare_raster("flagship_sun_shadow_4096", raster_setups(fgeometry, params, big)[1], 4096, 4096, True)
    )

    # the design's cases at flagship scale: depth ties and split lists
    config = default_scene_config(chess, chess_lib)
    params = upload_frame_params(pack_frame_params(chess, config.width / config.height), device)
    ties, _ = raster_setups(fgeometry, params, config, copies=2)
    design_reports = [
        compare_raster("flagship_camera_ties", ties, config.padded_width, config.padded_height, False),
        compare_raster("split_camera", split_case(device), 1920, 1088, False),
    ]
    # the flagship camera's lower row block, as render_frame_rows rasters it
    rows = config.padded_height - ROW_SPLIT
    block, _ = raster_setups(fgeometry, params, config, row0=ROW_SPLIT, local_rows=rows)
    origin_reports = [
        compare_raster("flagship_camera_rows", block, config.padded_width, rows, False, row0=ROW_SPLIT),
        compare_raster("flagship_camera_rows_depth", block, config.padded_width, rows, True, row0=ROW_SPLIT),
    ]
    check(all(r["covered_px"] > 100_000 for r in origin_reports), "the row block covers too few pixels")
    return reports + dense_reports + flagship_reports + design_reports + origin_reports


def phase_compare_gather(device):
    """lane_gather vs its plain version at each of GATHER_SIZES, on the
    bench's seeded inputs, bitwise; the kernel alone by CUDA events and on
    the device, ``torch.take`` as a yardstick. Returns the reports by
    size."""
    from syzygy_tpu_torch.kernels import gather
    from syzygy_tpu_torch.tools import gather_bench as bench

    reports = []
    for n in GATHER_SIZES:
        d = bench.bench_inputs(n)
        flat = torch.from_numpy(d["lut"][:, :, 0].reshape(-1).copy()).to(device)
        u, v = torch.from_numpy(d["u"]).to(device), torch.from_numpy(d["v"]).to(device)
        idx = gather.lut_index(u, v, bench.H, bench.W)
        del d, u, v
        plain = gather.lane_gather_plain(flat, idx)
        kern = gather.lane_gather(flat, idx)
        torch.cuda.synchronize()
        err = float((kern - plain).abs().max())
        check(torch.equal(kern, plain), f"lane_gather differs from its plain version by {err} at S = {n}")
        idx64 = idx.long()
        report = {"name": "lane_gather", "samples": n, "max_abs_err": err}
        # the kernel alone: its inputs were checked above
        report["ms"] = time_ms(lambda: gather._launch(flat, idx))
        report["device_ms"] = device_ms(lambda: gather._launch(flat, idx))
        report["plain_ms"] = time_ms(lambda: gather.lane_gather_plain(flat, idx))
        report["library_ms"] = time_ms(lambda: torch.take(flat, idx64))  # a yardstick; the port never calls it
        report["library_device_ms"] = device_ms(lambda: torch.take(flat, idx64))
        report["bound_ms"], report["bound_by"] = bound(4 * n + 4 * n + 4 * flat.numel(), 0)
        print("compare " + json.dumps(report), flush=True)
        reports.append(report)
        del flat, idx, idx64, plain, kern
    return reports


def phase_frames(name, scene, library, device, n_frames, warmup=1, dt_seconds=0.0):
    """A main path: ``n_frames`` frames through render_frame at the default
    1920x1080 RenderConfig, its raster launches counted."""
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    config = default_scene_config(scene, library)
    geometry = pack_geometry(scene, library, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    times, counts = [], []
    first = LAUNCHES.copy()
    for frame in range(n_frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = LAUNCHES.copy()
        start.record()
        params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
        image = render_frame(geometry, params, config)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        made = LAUNCHES - before
        counts.append((made["visibility"], made["depth"]))
        check(tuple(image.shape) == (config.height, config.width, 3), f"{name} frame shape {tuple(image.shape)}")
        check(bool(torch.isfinite(image).all()), f"{name} frame {frame} has non-finite values")
        check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, f"{name} frame {frame} outside [0, 1]")
        check(counts[-1][0] >= 1 and counts[-1][1] >= 1, f"{name} frame {frame} launched {counts[-1]}")
        print(
            f"{name} frame {frame}: {times[-1]:.3f} ms, sun time {scene.sun_animation.time:.4f}, "
            f"launches camera={counts[-1][0]} shadow={counts[-1][1]}, mean {float(image.mean()):.5f}",
            flush=True,
        )
        scene.tick(dt_seconds)
    result = {
        "scene": name,
        "frames": n_frames,
        "triangles": int(geometry.tri_valid.sum()),
        "metallic_reflection": config.metallic_reflection,
        "median_ms_per_frame": statistics.median(times[warmup:]),
        "ms_per_frame": times,
        "launches": {kind: (LAUNCHES - first)[kind] for kind in ("visibility", "depth")},
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated(device)),
        "resolution": [config.width, config.height],
    }
    print("frames " + json.dumps(result), flush=True)
    return result


def phase_gather_bench():
    """The port's gather bench at its default size, the lane gather's
    launches counted."""
    from syzygy_tpu_torch.kernels import gather
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.tools import gather_bench as bench

    before = LAUNCHES.copy()
    result = bench.main([])
    launches = (LAUNCHES - before)["lane_gather"]
    forms = result["forms"]
    check(sorted(forms) == [f"g{i}" for i in range(1, 8)], f"gather bench ran {sorted(forms)}")
    check(all(f["ms"] > 0 and f["checksum"] == f["checksum"] for f in forms.values()), "gather bench: bad timing/checksum")
    check(launches >= 1, "the gather bench never launched the lane gather kernel")
    # g7's output is the plain gather's: same checksum
    d = bench.bench_inputs(result["samples"])
    flat = torch.from_numpy(d["lut"][:, :, 0].reshape(-1).copy())
    plain = gather.lane_gather_plain(flat, gather.lut_index(torch.from_numpy(d["u"]), torch.from_numpy(d["v"]), bench.H, bench.W))
    check(forms["g7"]["checksum"] == float(plain.double().sum()), "g7 checksum differs from the plain gather's")
    summary = {k: {"ns_per_sample": v["ns_per_sample"], "checksum": v["checksum"]} for k, v in forms.items()}
    print("gather_bench " + json.dumps({"samples": result["samples"], "launches": launches, "forms": summary}), flush=True)
    return launches


def phase_golden(device):
    import numpy as np

    from syzygy_tpu_torch.bench import SCENE_EYE, SCENE_TARGET, look_at
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from syzygy_tpu_torch.scene.scene import default_scene
    from syzygy_tpu_torch.utils.png import read_png

    scene, library = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    look_at(scene, SCENE_EYE, SCENE_TARGET)
    config = RenderConfig(width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64)
    frames = {}
    for dev in (device, torch.device("cpu")):
        geometry = pack_geometry(scene, library, dev)
        params = upload_frame_params(pack_frame_params(scene, 2.0), dev)
        frames[dev.type] = render_frame(geometry, params, config).cpu().numpy()
    golden = read_png(GOLDEN)[..., :3].astype(np.float32) / 255.0
    rmse_cpu = float(np.sqrt(np.mean((frames["cuda"] - frames["cpu"]) ** 2)))
    rmse_golden = float(np.sqrt(np.mean((frames["cuda"] - golden) ** 2)))
    result = {
        "rmse_card_vs_cpu": rmse_cpu,
        "max_abs_card_vs_cpu": float(np.abs(frames["cuda"] - frames["cpu"]).max()),
        "rmse_card_vs_golden": rmse_golden,
    }
    print("golden " + json.dumps(result), flush=True)
    check(rmse_cpu <= 1e-3, f"card vs CPU RMSE {rmse_cpu}")
    check(rmse_golden < 5e-3, f"card vs golden RMSE {rmse_golden}")
    return result


def phase_flagship_golden(device):
    """The flagship at its golden config (``tests/test_golden_flagship.py:
    42-56``): card vs CPU port and vs the JAX package's u16 golden, RMSE
    <= 1e-3; card visibility ids vs the golden ids, exact but for flips at
    knife edges (< 1e-4 barycentric)."""
    import numpy as np

    from syzygy_tpu_torch.kernels.raster import rasterize
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    w, h = 512, 288
    scene, library = flagship()
    config = RenderConfig(width=w, height=h, shadow_dim=512, skyview_width=256, skyview_height=128)
    frames = {}
    for dev in (device, torch.device("cpu")):
        geometry = pack_geometry(scene, library, dev)
        params = upload_frame_params(pack_frame_params(scene, w / h), dev)
        frames[dev.type] = render_frame(geometry, params, config).cpu().numpy()
        if dev == device:
            (setup, _), _ = raster_setups(geometry, params, config)
            tri = rasterize(setup, config.padded_width, config.padded_height).tri[:h, :w]
    card = frames[device.type]
    golden = np.load(FLAGSHIP_FRAME)["img"].astype(np.float32) / 65535.0
    golden_tri = torch.from_numpy(np.load(FLAGSHIP_VIS)["tri"]).to(device)
    differ = tri != golden_tri
    flips = int(differ.sum())
    worst = 0.0
    if flips:
        ys, xs = torch.nonzero(differ, as_tuple=True)
        worst = max(edge_distance(setup, ys, xs, ids) for ids in (tri[ys, xs], golden_tri[ys, xs]))
    result = {
        "rmse_card_vs_cpu": float(np.sqrt(np.mean((card - frames["cpu"]) ** 2))),
        "max_abs_card_vs_cpu": float(np.abs(card - frames["cpu"]).max()),
        "rmse_card_vs_golden": float(np.sqrt(np.mean((card - golden) ** 2))),
        "vis_flips_vs_golden": flips,
        "vis_flip_max_edge_distance": worst,
    }
    print("flagship_golden " + json.dumps(result), flush=True)
    check(result["rmse_card_vs_cpu"] <= 1e-3, f"flagship card vs CPU RMSE {result['rmse_card_vs_cpu']}")
    check(result["rmse_card_vs_golden"] <= 1e-3, f"flagship card vs golden RMSE {result['rmse_card_vs_golden']}")
    check(worst < EDGE_TOL, f"flagship visibility: {flips} flips, up to {worst} from an edge")
    return result


def phase_flagship_1080p(device, n_frames=3):
    """The quirk-exact main path at full size: the chess flagship at
    1920x1080 in ``tools/parity_1080p.py``'s configuration with the f32
    storage of the golden's date (``GOLDEN_STORAGE``, an f32 atlas), a few
    frames on the card, their raster launches counted, the last frame held against ``flagship_1080p.npz``
    (that tool's CPU render of the JAX package, u16) under its verdict.
    Then, each with a count of its own that stays out of the main path's:
    the same frame through ``render_frame_packed`` and as two stacked
    blocks of ``render_frame_rows``, bitwise ``render_frame``'s; and, for
    the record and with no verdict, frames at the tool's configuration
    under today's default storage (f16 PCF and atlas, q8 sky-view)."""
    import numpy as np

    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import (
        RenderConfig,
        render_frame,
        render_frame_packed,
        render_frame_rows,
    )
    from syzygy_tpu_torch.scene.pack import (
        flatten_frame_params,
        frame_param_spec,
        pack_frame_params,
        pack_geometry,
        upload_frame_params,
    )

    scene, library = flagship()
    config = RenderConfig(**EXACT_CONFIG, **GOLDEN_STORAGE)
    geometry = pack_geometry(scene, library, device, atlas_f16=False)
    host = pack_frame_params(scene, config.width / config.height)
    golden = np.load(FLAGSHIP_1080P)["img"].astype(np.float32) / 65535.0

    def against_golden(frame):
        d = np.abs(frame.cpu().numpy() - golden)
        outliers = d.max(axis=-1) > PARITY_OUTLIER
        return {
            "rmse_whole_frame": float(np.sqrt(np.mean(d ** 2))),
            "max_abs": float(d.max()),
            "pixels_over_0.01": int(outliers.sum()),
            "rmse_excluding_them": float(np.sqrt((d[~outliers] ** 2).mean())),
        }

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    first = LAUNCHES.copy()
    times = []
    for frame in range(n_frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = LAUNCHES.copy()
        start.record()
        image = render_frame(geometry, upload_frame_params(host, device), config)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        made = LAUNCHES - before
        counts = (made["visibility"], made["depth"])
        check(counts[0] == 1 and counts[1] >= 1, f"flagship_1080p frame {frame} launched {counts}")
        print(f"flagship_1080p frame {frame}: {times[-1]:.3f} ms, launches camera={counts[0]} shadow={counts[1]}", flush=True)
    launches = {kind: (LAUNCHES - first)[kind] for kind in ("visibility", "depth")}
    peak = int(torch.cuda.max_memory_allocated(device))
    check(tuple(image.shape) == (config.height, config.width, 3), f"flagship_1080p shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()), "flagship_1080p frame has non-finite values")

    def counted(render):
        """``render()`` and the raster launches it made."""
        before = LAUNCHES.copy()
        out = render()
        torch.cuda.synchronize()
        made = {kind: (LAUNCHES - before)[kind] for kind in ("visibility", "depth")}
        check(made["visibility"] >= 1 and made["depth"] >= 1, f"1080p: launched {made}")
        return out, made

    spec = frame_param_spec(host)
    packed, packed_launches = counted(
        lambda: render_frame_packed(geometry, flatten_frame_params(host, spec), spec, config)
    )
    blocks, rows_launches = counted(lambda: [
        render_frame_rows(geometry, upload_frame_params(host, device), config, row0, rows)
        for row0, rows in ((0, ROW_SPLIT), (ROW_SPLIT, config.padded_height - ROW_SPLIT))
    ])
    stacked = torch.cat(blocks, dim=0)[: config.height, : config.width]

    today_geometry, today_config, today_times = pack_geometry(scene, library, device), RenderConfig(**EXACT_CONFIG), []
    for _ in range(n_frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        today, today_launches = counted(
            lambda: render_frame(today_geometry, upload_frame_params(host, device), today_config)
        )
        end.record()
        torch.cuda.synchronize()
        today_times.append(start.elapsed_time(end))

    result = {
        "config": EXACT_CONFIG | GOLDEN_STORAGE | {"atlas_f16": False},
        "frames": n_frames,
        "median_ms_per_frame": statistics.median(times[1:]),
        "ms_per_frame": times,
        "launches": launches,
        "peak_mem_bytes": peak,
        **against_golden(image),
        "pixels_over_0.01_allowed": golden.shape[0] * golden.shape[1] // PARITY_OUTLIER_SHARE,
        "packed_bitwise": bool(torch.equal(packed, image)),
        "packed_launches": packed_launches,
        "rows_bitwise": bool(torch.equal(stacked, image)),
        "rows_launches": rows_launches,
        "todays_default_storage": {
            "median_ms_per_frame": statistics.median(today_times[1:]),
            "ms_per_frame": today_times,
            "launches_per_frame": today_launches,
            **against_golden(today),
        },
    }
    print("flagship_1080p " + json.dumps(result), flush=True)
    check(result["rmse_excluding_them"] <= PARITY_RMSE, f"1080p shaded RMSE {result['rmse_excluding_them']}")
    check(
        result["pixels_over_0.01"] <= result["pixels_over_0.01_allowed"],
        f"1080p: {result['pixels_over_0.01']} pixels differ from the golden by more than {PARITY_OUTLIER}",
    )
    check(result["packed_bitwise"], "render_frame_packed differs from render_frame on the card")
    check(result["rows_bitwise"], "stacked render_frame_rows blocks differ from render_frame on the card")
    return result


def phase_feature_frames(device):
    """The frames of the other configurations at the flagship golden size
    (512x288), card against the CPU port, RMSE <= 1e-3 each: the
    mip-mapped resolve, the debug lines (with the atmosphere, without it,
    and under supersample 2), the fast sky with and without the aerial
    LUT, the u8 PCF segments, the f16 sky LUT copies, the shared sun PCF,
    and 4096-texel shadow maps (the depth raster at 4096^2, the direct
    f32 PCF). The mip, fast sky, q8 and f16-LUT frames must differ from
    the plain frame (the feature is live); the shared sun PCF must equal
    it bitwise. Each case's card frame time (CUDA events, mean of
    ``FEATURE_REPS`` after one warm-up) and raster launches per frame are
    printed beside the card's name and power limit."""
    import numpy as np

    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    w, h = 512, 288
    scene, library = flagship()
    base = dict(width=w, height=h, shadow_dim=512, skyview_width=256, skyview_height=128)
    cases = {
        "plain": {},
        "mipmaps": {},
        "debug_lines": dict(debug_lines=True),
        "debug_lines_no_atmosphere": dict(debug_lines=True, render_atmosphere=False),
        "debug_lines_supersample2": dict(debug_lines=True, supersample=2, width=w // 2, height=h // 2),
        "fast_sky": dict(fast_sky=True),
        "fast_sky_exact": dict(fast_sky=True, aerial_lut=False),
        "pcf_q8": dict(pcf_q8=True),
        "lut_f16": dict(lut_f16=True),
        "share_sun_pcf": dict(share_sun_pcf=True),
        "shadow_dim_4096": dict(shadow_dim=4096),
    }
    results, frames, card_ms = {}, {}, {}
    for name, overrides in cases.items():
        config = RenderConfig(**(base | overrides))
        host = pack_frame_params(scene, w / h, debug_lines=config.debug_lines)
        out = {}
        for dev in (device, torch.device("cpu")):
            geometry = pack_geometry(scene, library, dev, mipmaps=(name == "mipmaps"))
            out[dev.type] = render_frame(geometry, upload_frame_params(host, dev), config).cpu().numpy()
            if dev.type == "cuda":
                before = LAUNCHES.copy()
                ms = time_ms(lambda: render_frame(geometry, upload_frame_params(host, dev), config), FEATURE_REPS)
                frames_run = FEATURE_REPS + 1  # the warm-up launches too
                made = LAUNCHES - before
                card_ms[name] = {
                    "ms_per_frame": ms,
                    "launches_per_frame": {kind: made[kind] / frames_run for kind in ("visibility", "depth")},
                }
        check(out["cuda"].shape == (config.height, config.width, 3), f"{name}: shape {out['cuda'].shape}")
        check(bool(np.isfinite(out["cuda"]).all()), f"{name}: non-finite values")
        frames[name] = out["cuda"]
        results[name] = {
            "rmse_card_vs_cpu": float(np.sqrt(np.mean((out["cuda"] - out["cpu"]) ** 2))),
            "max_abs_card_vs_cpu": float(np.abs(out["cuda"] - out["cpu"]).max()),
        }
        if name in ("plain", "shadow_dim_4096"):  # where do card and CPU part on the sun's shadow?
            chain = shadow_chain_diff(
                *(sun_shadow_chain(scene, library, host, config, dev) for dev in (device, torch.device("cpu"))),
                config, (out["cuda"], out["cpu"]),
            )
            results[name]["shadow_map_texels_card_vs_cpu"] = chain["map_texels_differ"]
            results[name]["sun_shadow_chain"] = chain
            check(
                not any(chain["cpu_frame_on_card_inputs_differ"].values())
                and chain["cpu_pcf_on_card_coords"]["tap_pixels_differ"] == 0,
                f"{name}: the card's shadow frame or taps are not the CPU code's on the card's inputs",
            )
    for name in ("debug_lines", "debug_lines_no_atmosphere"):
        f = frames[name]  # the overlay's green, encoded: (0, ~1, 0)
        results[name]["line_pixels"] = int(((f[..., 0] == 0) & (f[..., 1] > 0.999) & (f[..., 2] == 0)).sum())
        check(results[name]["line_pixels"] > 500, f"{name}: {results[name]['line_pixels']} line pixels")
    for name in ("mipmaps", "fast_sky", "fast_sky_exact", "pcf_q8", "lut_f16"):
        results[name]["rmse_vs_plain"] = float(np.sqrt(np.mean((frames[name] - frames["plain"]) ** 2)))
        check(results[name]["rmse_vs_plain"] > 0.0, f"{name}: the frame equals the plain one")
    results["share_sun_pcf"]["bitwise_plain"] = bool(np.array_equal(frames["share_sun_pcf"], frames["plain"]))
    check(results["share_sun_pcf"]["bitwise_plain"], "share_sun_pcf: the card frame differs from the plain card frame")
    check(card_ms["shadow_dim_4096"]["launches_per_frame"]["depth"] >= 1, "shadow_dim_4096: no depth raster launched")
    print(f"feature_frames card ms ({nvidia_smi_line()}) " + json.dumps(card_ms), flush=True)
    print("feature_frames arithmetic " + json.dumps(arithmetic_probe(device)), flush=True)
    print("feature_frames " + json.dumps(results), flush=True)
    for name, r in results.items():
        check(r["rmse_card_vs_cpu"] <= 1e-3, f"{name}: card vs CPU RMSE {r['rmse_card_vs_cpu']}")
    return results


def sun_shadow_chain(scene, library, host, config, dev) -> dict:
    """The sun's shadow lookup as the frame makes it on ``dev``, each stage
    copied to the CPU: the visibility buffer, the G-buffer's world
    position and normal, the sun's light matrix, the shadow coordinates
    and PCF footprint (``compute_shadow_frame``), the sun's map and its
    PCF factors (``_sun_pcf``, what the lighting and the sky pass read)."""
    from syzygy_tpu_torch.kernels.lighting import compute_shadow_frame, convert_pbr
    from syzygy_tpu_torch.math.geometry import matmul4
    from syzygy_tpu_torch.renderer.frame import _stage_geometry, _sun_pcf
    from syzygy_tpu_torch.scene.pack import pack_geometry, upload_frame_params

    state, vis, gbuffer, maps = _stage_geometry(
        pack_geometry(scene, library, dev), upload_frame_params(host, dev), config
    )
    material = convert_pbr(gbuffer)
    sun = type(state.directional_lights)(*[x[0] for x in state.directional_lights])
    light = matmul4(sun.projection, sun.view)
    coord, dx, dy = compute_shadow_frame(light, material.position, material.normal)
    stages = dict(
        tri=vis.tri, b0=vis.b0, b1=vis.b1, position=material.position, normal=material.normal, light=light,
        coord=coord[..., :3], dx=dx, dy=dy, map=maps[0], factor=_sun_pcf(state, gbuffer, maps, config),
        lit=gbuffer.diffuse[..., 3] >= 1.0,
    )
    return {k: v.cpu() for k, v in stages.items()}


def _ulps(a, b):
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def shadow_chain_diff(card, cpu, config, frames) -> dict:
    """Where the card's sun shadow lookup leaves the CPU port's, stage by
    stage over the pixels both shade: the values that differ at each stage
    and by how many f32 ulps, the PCF factors that differ and the taps
    behind them (a tap is 1/25 of a factor); two swaps that place the
    cause: the CPU's shadow frame on the card's position, normal and light
    matrix, and the CPU's PCF on the card's coordinates (the maps are
    bitwise alike when ``map_texels_differ`` is 0); and how much of the
    frames' (card, CPU) difference lies on the pixels whose taps differ."""
    from syzygy_tpu_torch.kernels.lighting import compute_shadow_frame, sample_shadow_map

    lit = card["lit"] & cpu["lit"]
    out = {
        "pixels": int(lit.sum()),
        "lit_differ": int((card["lit"] != cpu["lit"]).sum()),
        "map_texels_differ": int((card["map"] != cpu["map"]).sum()),
        "light_matrix_bitwise": bool(torch.equal(card["light"], cpu["light"])),
    }
    for key in ("tri", "b0", "b1"):
        out[f"{key}_differ"] = int((card[key] != cpu[key]).sum())
    for key in ("position", "normal", "coord", "dx", "dy"):
        a, b = card[key][lit], cpu[key][lit]
        ulps = _ulps(a, b)
        out[key] = {
            "values_differ": int((a != b).sum()),
            "max_ulps": int(ulps.max()) if ulps.numel() else 0,
            "ulps_1": int((ulps == 1).sum()), "ulps_2": int((ulps == 2).sum()), "ulps_over_2": int((ulps > 2).sum()),
        }
    def occluded(factor):  # the taps that found an occluder, an integer count
        return torch.round((1.0 - factor) * 25.0)

    taps = (occluded(card["factor"]) - occluded(cpu["factor"])).abs() * lit
    out["factor"] = {
        "differ": int((card["factor"] != cpu["factor"])[lit].sum()),
        "differ_same_taps": int(((card["factor"] != cpu["factor"]) & (taps == 0))[lit].sum()),
        "max_abs_same_taps": float(((card["factor"] - cpu["factor"]).abs() * (taps == 0) * lit).max()),
        "tap_pixels": int((taps > 0).sum()), "taps": int(taps.sum()), "max_taps": int(taps.max()),
    }
    coord, dx, dy = compute_shadow_frame(card["light"], card["position"], card["normal"])
    out["cpu_frame_on_card_inputs_differ"] = {
        "coord": int((coord[..., :3] != card["coord"])[lit].sum()),
        "dx": int((dx != card["dx"])[lit].sum()), "dy": int((dy != card["dy"])[lit].sum()),
    }
    pcf = sample_shadow_map(cpu["map"], card["coord"], card["dx"], card["dy"], f16=config.pcf_f16, q8=config.pcf_q8)
    out["cpu_pcf_on_card_coords"] = {
        "factors_differ": int((pcf != card["factor"])[lit].sum()),
        "tap_pixels_differ": int(((occluded(pcf) != occluded(card["factor"])) & lit).sum()),
    }
    h, w = frames[0].shape[:2]
    flipped = (taps[:h, :w] > 0).numpy()
    err = (frames[0] - frames[1]) ** 2
    out["frame"] = {
        "rmse_card_vs_cpu": float(err.mean() ** 0.5),
        "rmse_without_tap_pixels": float(err[~flipped].mean() ** 0.5),
        "max_abs_at_tap_pixels": float(err[flipped].max() ** 0.5) if flipped.any() else 0.0,
        "max_abs_elsewhere": float(err[~flipped].max() ** 0.5),
    }
    return out


def arithmetic_probe(device, n=1 << 20) -> dict:
    """Two roundings of the shadow lookup's path, on the card and on the
    CPU: which order ``torch.sum`` takes over a last axis of 3 (the sums
    of n seeded triples, signs and magnitudes spread over 6 decades, that
    differ from each explicit order), and the PCF's ``occluded / 25``
    for the 26 tap counts against the CPU's quotient."""
    g = torch.Generator().manual_seed(3)
    x = (torch.rand((n, 3), generator=g) - 0.5) * 10.0 ** (torch.rand((n, 3), generator=g) * 6.0 - 3.0)
    orders = {
        "(a+b)+c": (x[:, 0] + x[:, 1]) + x[:, 2],
        "a+(b+c)": x[:, 0] + (x[:, 1] + x[:, 2]),
        "(a+c)+b": (x[:, 0] + x[:, 2]) + x[:, 1],
    }
    counts = torch.arange(26, dtype=torch.float32)
    out = {}
    for dev in (device, torch.device("cpu")):
        total = torch.sum(x.to(dev), dim=-1).cpu()
        out[dev.type] = {
            "sum3_differs_from": {name: int((total != want).sum()) for name, want in orders.items()},
            "div25_differs_from_cpu": int(((counts.to(dev) / 25.0).cpu() != counts / 25.0).sum()),
        }
    return out


LIGHTING_PLAIN_REPS = 3  # the plain lighting's calls per timing (~100 ms and ~12,000 kernels each)
LIT_BYTES_PER_PIXEL = 5 * 16  # a lit pixel reads five (H, W, 4) f32 G-buffer texels
BACKGROUND_BYTES_PER_PIXEL = 16  # a background pixel reads its diffuse texel alone
LIGHT_BYTES_PER_PIXEL = 3 * 4  # every pixel writes its (H, W, 3) f32 output
LIGHTING_CASES = (  # name, scene, shadow_dim, pcf_q8, every slot live
    ("editor", "editor", 8192, False, False),
    ("chess", "chess", 8192, False, False),
    ("all_slots", "editor", 8192, False, True),
    ("chess_q8", "chess", 2048, True, False),
    ("all_slots_q8", "editor", 2048, True, True),
)


def lighting_bytes(pixels: int, lit: int, live: int, q8: bool) -> int:
    """A lower bound on the lighting kernel's bytes: each lit pixel's five
    G-buffer texels, each background pixel's diffuse texel, every pixel's
    output, and one map texel (4 B; a 2 B code for q8) for each live slot
    and lit pixel."""
    texel = 2 if q8 else 4
    return lit * LIT_BYTES_PER_PIXEL + (pixels - lit) * BACKGROUND_BYTES_PER_PIXEL + pixels * LIGHT_BYTES_PER_PIXEL \
        + lit * live * texel


def phase_compare_lighting(device):
    """The lighting kernel (``csrc/lighting.cu``) vs
    ``deferred_lighting_plain`` on the card, bitwise, at 1920x1088 with
    the shadowless gate of the default config: the cells' settings
    (8192^2 maps read in f32) on the editor's default scene with its sun
    animated and on the chess flagship, every one of the 2 + 16 slots
    live (``bench.all_slots_live``, gate off), and those of the chess and
    all-slots cases again with ``pcf_q8`` maps of 2048 texels. Each case:
    the slots the kernel evaluated (its mask, ``kernels.lighting.
    evaluated_slots``) against the live masks; the kernel's own device
    time (``ms``), the whole call (the masks' and tables' prologue
    included) by CUDA events and on the device; the plain version
    likewise; the bytes bound (:func:`lighting_bytes` at the HBM rate)."""
    from syzygy_tpu_torch.bench import all_slots_live, chess_scene, default_scene_animated
    from syzygy_tpu_torch.kernels import lighting as L
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import RenderConfig, _geometry
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    reports = []
    for name, scene_name, dim, q8, every in LIGHTING_CASES:
        scene, library = chess_scene() if scene_name == "chess" else default_scene_animated()
        eps = 0.0 if every else RenderConfig().shadowless_strength_eps
        config = RenderConfig(width=1920, height=1080, shadow_dim=dim, pcf_q8=q8, shadowless_strength_eps=eps)
        geometry = pack_geometry(scene, library, device)
        params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
        with torch.no_grad():
            state, _, gbuffer, maps, _ = _geometry(geometry, params, config, 0, config.padded_height)
            lights = dict(
                directional=state.directional_lights, directional_count=state.directional_count,
                directional_skip=state.directional_skip_count, spots=state.spot_lights, spot_count=state.spot_count,
            )
            if every:
                lights, maps = all_slots_live(state, maps)
            args = (gbuffer, state.camera, *lights.values(), maps)
            flags = dict(pcf_f16=config.pcf_f16, pcf_q8=q8, shadowless_eps=eps)
            before = LAUNCHES.copy()
            kern = L.deferred_lighting(*args, **flags)
            launches = (LAUNCHES - before)["lighting"]
            plain = L.deferred_lighting_plain(*args, **flags)
            torch.cuda.synchronize()
            differ = int((kern != plain).any(dim=-1).sum())
            check(differ == 0, f"lighting ({name}) differs from its plain version at {differ} pixels")
            check(launches == 1, f"lighting ({name}) launched {launches} kernels, not 1")
            activity = L.light_activity(*lights.values(), eps, maps.shape[0])
            live = int(activity.shadowed_dirs.sum() + activity.unshadowed_dirs.sum() + activity.spots.sum())
            slots = L.evaluated_slots(L.last_slot_mask(device))
            check(slots == live, f"lighting ({name}) evaluated {slots} slots, {live} are live")
            rows, width = gbuffer.diffuse.shape[:2]
            lit = int((gbuffer.diffuse[..., 3] >= 1.0).sum())

            def call():
                L.deferred_lighting(*args, **flags)

            report = {"name": f"lighting_{name}", "shape": [rows, width], "shadow_dim": dim, "q8": q8,
                      "slots": slots, "lit_pixels": lit, "max_abs_err": 0.0, "bitwise": True, "launches": launches,
                      "ms": device_ms(call, kernel="lighting_kernel"), "call_ms": time_ms(call),
                      "call_device_ms": device_ms(call)}
            report["plain_ms"] = time_ms(lambda: L.deferred_lighting_plain(*args, **flags), LIGHTING_PLAIN_REPS)
            report["plain_device_ms"] = device_ms(lambda: L.deferred_lighting_plain(*args, **flags), LIGHTING_PLAIN_REPS)
            report["bound_ms"], report["bound_by"] = bound(lighting_bytes(rows * width, lit, live, q8), 0)
        print("compare " + json.dumps(report), flush=True)
        reports.append(report)
        del state, gbuffer, maps, kern, plain, args, lights, activity
        torch.cuda.empty_cache()
    return reports


SCATTERING_PLAIN_REPS = 2  # the plain integral's calls per timing (~14,500 kernels each)
# the cells' integrals: name, scene, RenderConfig overrides (at 1920x1080)
SCATTERING_CASES = (
    ("editor", "editor", {}),
    ("chess_quirk_exact", "chess", dict(aerial_lut=False, fast_sky_reflection=False)),
)
SCATTERING_CALLS = {  # the integrals each case's frame calls, in order
    "editor": ("skyview_rows", "aerial_froxels"),
    "chess_quirk_exact": ("skyview_rows", "per_pixel", "bounce"),
}


def integral_calls(scene, library, config, device):
    """Every in-scattering integral one eager frame calls, in call order:
    (components, args) as ``kernels.atmosphere._integral`` receives them."""
    from syzygy_tpu_torch.kernels import atmosphere
    from syzygy_tpu_torch.renderer.frame import render_frame_eager
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    geometry = pack_geometry(scene, library, device)
    params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
    calls = []
    real = atmosphere._integral

    def spy(components, *args):
        calls.append((components, args))
        return real(components, *args)

    atmosphere._integral = spy
    try:
        with torch.no_grad():
            render_frame_eager(geometry, params, config)
    finally:
        atmosphere._integral = real
    torch.cuda.synchronize()
    return calls


def phase_compare_scattering(device):
    """The in-scattering kernel (``csrc/scattering.cu``) vs its plain
    version on the card, bitwise, on every integral a 1920x1080 frame of
    the cells calls: the editor's default scene (the sky-view rows in
    components form, the 16x32x32 aerial froxels) and the chess flagship's
    quirk-exact frame (the sky-view rows, the per-pixel integral from the
    eye, the metallic bounce's from every surface). Each call: the
    elements that differ and the largest difference, its launches and
    rays, the kernel's own device time (``ms``), the whole call (the
    table's and the rays' prologue included) by CUDA events, the plain
    version by CUDA events, and the operations bound: the rays of non-zero
    distance (a ray of distance 0 takes one step 32 times) x 32 steps x
    ``frame_bench/aerial_work.py``'s ``OPS_PER_STEP`` at the fp32 rate."""
    from frame_bench.aerial_work import OPS_PER_STEP, STEPS
    from syzygy_tpu_torch.bench import chess_scene, default_scene_animated
    from syzygy_tpu_torch.kernels import atmosphere as A
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    plain_of = {True: A._scattering_integral_components_plain, False: A.luminance_scattering_integral_plain}
    reports = []
    for case, scene_name, overrides in SCATTERING_CASES:
        scene, library = chess_scene() if scene_name == "chess" else default_scene_animated()
        config = RenderConfig(**(dict(width=1920, height=1080) | overrides))
        calls = integral_calls(scene, library, config, device)
        names = SCATTERING_CALLS[case]
        check(len(calls) == len(names), f"scattering ({case}): the frame called {len(calls)} integrals, not {len(names)}")
        for name, (components, args) in zip(names, calls):
            plain = plain_of[components]
            with torch.no_grad():
                before = LAUNCHES.copy()
                kern = A._integral(components, *args)
                made = LAUNCHES - before
                launches, rays = made["scattering"], made["scattering_rays"]
                want = plain(*args)
                torch.cuda.synchronize()
                kern, want = (kern, want) if components else ((kern,), (want,))
                differ = sum(int((k != w).sum()) for k, w in zip(kern, want))
                max_abs = max(float((k - w).abs().max()) for k, w in zip(kern, want))
            check(differ == 0, f"scattering ({case} {name}) differs from its plain version at {differ} elements")
            n = args[4].numel()
            check(launches == 1 and rays == n, f"scattering ({case} {name}): {launches} launches over {rays} rays")
            counted = int((args[4] != 0).sum())

            def call():
                with torch.no_grad():
                    A._integral(components, *args)

            report = {"name": f"scattering_{case}_{name}", "components": components, "rays": n,
                      "rays_counted": counted, "origin_stride": A._rays(*args[2:])[1], "differ": differ,
                      "max_abs_err": max_abs, "bitwise": True, "launches": launches,
                      "ms": device_ms(call, kernel="scattering_kernel"), "call_ms": time_ms(call)}
            with torch.no_grad():
                report["plain_ms"] = time_ms(lambda: plain(*args), SCATTERING_PLAIN_REPS)
            report["bound_ms"], report["bound_by"] = bound(0, counted * STEPS * OPS_PER_STEP)
            print("compare " + json.dumps(report), flush=True)
            reports.append(report)
        del calls, kern, want
        torch.cuda.empty_cache()
    return reports


SKY_PLAIN_REPS = 3  # the plain sky pass's calls per timing (~16 ms and ~1,250 kernels each)
SKY_GEOMETRY_BYTES = 5 * 16 + 4 + 12 + 4 + 12  # planes, depth, lit colour, one sun-map texel in; colour out
SKY_ENVIRONMENT_BYTES = 4 + 16 + 12  # depth and the world position's texel in; colour out


def sky_call(scene, library, config, device):
    """The sky pass's (args, keywords) as one eager frame calls it."""
    from syzygy_tpu_torch.renderer import frame
    from syzygy_tpu_torch.renderer.frame import render_frame_eager
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    geometry = pack_geometry(scene, library, device)
    params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
    calls = []
    real = frame.sky_camera_pass

    def spy(*args, **kwargs):
        calls.append((args[:8] + (args[8].clone(),) + args[9:], kwargs))
        return real(*args, **kwargs)

    frame.sky_camera_pass = spy
    try:
        with torch.no_grad():
            render_frame_eager(geometry, params, config)
    finally:
        frame.sky_camera_pass = real
    torch.cuda.synchronize()
    return calls[0]


def phase_compare_sky(device):
    """The LUT sky camera pass (``csrc/sky.cu``) vs
    ``sky_camera_pass_lut_plain`` on the card, bitwise, at the cells'
    settings (1920x1088, the sun's 8192^2 map in f32 taps, the q8 sky-view
    LUT, the t_seg rows): the editor's default scene with its sun animated
    (no metallic bounce) and the chess flagship (the bounce). Each case:
    one launch; the kernel's own device time (``ms``), the whole call (the
    table's prologue included) by CUDA events and on the device, and its
    kernels; the plain pass likewise; the bytes bound (a geometry pixel's
    ``SKY_GEOMETRY_BYTES``, an environment pixel's
    ``SKY_ENVIRONMENT_BYTES``, at the HBM rate)."""
    from syzygy_tpu_torch.bench import chess_scene, default_scene_animated
    from syzygy_tpu_torch.kernels import sky as S
    from syzygy_tpu_torch.kernels.build import LAUNCHES

    reports = []
    for name in ("editor", "chess"):
        scene, library = chess_scene() if name == "chess" else default_scene_animated()
        config = default_scene_config(scene, library, width=1920, height=1080, shadow_dim=8192)
        args, kw = sky_call(scene, library, config, device)
        settings = (kw["draw_extent"], kw["aerial_t_max"], kw["metallic_reflection"], kw["pcf_f16"], kw["pcf_q8"],
                    kw["row_origin"])

        def call():
            with torch.no_grad():
                return S.sky_camera_pass(*args, **kw)

        def plain():
            with torch.no_grad():
                return S.sky_camera_pass_lut_plain(*args, kw["aerial"], kw["tseg_rows"], kw["sun_shadow"], *settings)

        before = LAUNCHES.copy()
        kern = call()
        launches = (LAUNCHES - before)["sky"]
        want = plain()
        torch.cuda.synchronize()
        differ = int((kern.view(torch.int32) != want.view(torch.int32)).any(dim=-1).sum())
        check(differ == 0, f"sky pass ({name}) differs from its plain version at {differ} pixels")
        check(launches == 1, f"sky pass ({name}) launched {launches} kernels, not 1")
        depth, position = args[1], args[2].world_position
        env = int(((depth == 0) | (position[..., 1] > 0)).sum())
        pixels = depth.numel()
        report = {"name": f"sky_{name}", "shape": list(depth.shape), "metallic": kw["metallic_reflection"],
                  "environment_pixels": env, "max_abs_err": 0.0, "bitwise": True, "launches": launches,
                  "ms": device_ms(call, kernel="sky_kernel"), "call_ms": time_ms(call),
                  "call_device_ms": device_ms(call)}
        report["plain_ms"] = time_ms(plain, SKY_PLAIN_REPS)
        report["plain_device_ms"] = device_ms(plain, SKY_PLAIN_REPS)
        report["bound_ms"], report["bound_by"] = bound(
            (pixels - env) * SKY_GEOMETRY_BYTES + env * SKY_ENVIRONMENT_BYTES, 0)
        print("compare " + json.dumps(report), flush=True)
        reports.append(report)
        del args, kw, kern, want
        torch.cuda.empty_cache()
    return reports


BENCH_FRAMES = 8  # replayed frames per scene in phase_bench


def phase_compare_stamp(device):
    """The layer stamp (``kernels/stamp.py``) vs ``stamp_plain`` on a copy,
    on a ring of the main path's shape (``RING_REPLAYS`` x ``MARKS + 1``)
    whose sequence column holds the replays one lap earlier: three whole
    frames of ``MARKS`` stamps across the ring's wrap, then a frame cut
    after four. The sequence column and the counter must be the plain
    version's exactly, the same cells must hold times, and each slot's
    times must run in mark order. The stamp alone timed by CUDA events
    and on the device, the plain one on the host's clock."""
    from syzygy_tpu_torch.kernels import stamp as st
    from syzygy_tpu_torch.renderer.layers import MARKS, RING_REPLAYS

    rows, stride = RING_REPLAYS, MARKS + 1
    ring = torch.full((rows, stride), -1, dtype=torch.int64, device=device)
    ring[:, -1] = torch.arange(rows, device=device) + rows  # lap 1's replays
    seq = torch.tensor(3 * rows - 2, dtype=torch.int64, device=device)  # lap 2's last two slots, then slot 0
    plain_ring, plain_seq = ring.cpu().clone(), seq.cpu().clone()
    frames = [MARKS] * 3 + [4]
    for marks in frames:
        for mark in range(marks):
            last = mark == MARKS - 1
            st.stamp(ring, seq, mark, last)
            st.stamp_plain(plain_ring, plain_seq, mark, last)
    torch.cuda.synchronize()
    got = ring.cpu()
    check(int(seq) == int(plain_seq) == 3 * rows + 1, f"stamp counter {int(seq)}, plain {int(plain_seq)}")
    check(torch.equal(got[:, -1], plain_ring[:, -1]), "the stamp's sequence column differs from its plain version's")
    written = got[:, :-1] != -1
    check(torch.equal(written, plain_ring[:, :-1] != -1), "the stamp wrote other cells than its plain version")
    slots = [(3 * rows - 2 + f) % rows for f in range(len(frames))]
    check(int(written.sum()) == sum(frames), f"the stamp wrote {int(written.sum())} times, not {sum(frames)}")
    for slot, marks in zip(slots, frames):
        times = got[slot, :marks]
        check(bool((times[1:] >= times[:-1]).all()), f"slot {slot}: stamp times out of mark order {times.tolist()}")
    check([int(got[s, -1]) for s in slots] == [3 * rows - 2, 3 * rows - 1, 3 * rows, -1],
          f"sequence numbers {[int(got[s, -1]) for s in slots]} in slots {slots}")
    report = {"name": "stamp", "rows": rows, "stride": stride, "max_abs_err": 0}
    report["ms"] = time_ms(lambda: st.stamp(ring, seq, 1, False))
    report["device_ms"] = device_ms(lambda: st.stamp(ring, seq, 1, False))
    t0 = time.perf_counter()
    for _ in range(REPS):
        st.stamp_plain(plain_ring, plain_seq, 1, False)
    report["plain_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    report["bound_ms"], report["bound_by"] = bound(3 * 8, 0)  # the counter read, a time and a sequence number
    report["part"] = compare_part_stamp(device)
    print("compare " + json.dumps(report), flush=True)
    return report


PART_SLEEPS = {  # SM cycles a part sleeps in compare_part_stamp (~30-75 us each)
    "shadow.setup": 120_000, "shadow.bin": 60_000, "shadow.raster": 90_000, "gbuffer.setup": 100_000,
    "gbuffer.bin": 70_000, "gbuffer.raster": 80_000, "gbuffer.resolve": 150_000,
}
STAMP_MS = 0.005  # what a stamp may add to an interval: its launch in a graph and its run (~1.4 us)


def compare_part_stamp(device):
    """A main path's parts as ``renderer/layers.py`` stamps them: a
    :class:`FrameTrace` of ten shadow slots records, inside a CUDA graph,
    ``state``, then ten times (``shadow.setup``, ``.bin``, ``.raster``)
    in ``shadow`` and the camera's four parts in ``gbuffer``, each part one
    ``torch.cuda._sleep`` of its own length (:data:`PART_SLEEPS`), each
    binning tallying counters of its own. Two replays. Each part's sum must
    be its sleeps' time (CUDA events, the sleeps alone) within a stamp's
    cost an interval and 2%; the parts' sum at most ``shadow`` +
    ``gbuffer`` as their layer stamps read them and at least that less
    four stamps' cost (the gaps at each layer's two ends); the counters
    exactly their sums; and a CPU trace of the same sequence must write the
    same cells and record the same intervals. The part stamp with its
    counters timed alone."""
    from syzygy_tpu_torch.kernels import stamp as st
    from syzygy_tpu_torch.renderer.layers import MARKS, FrameTrace, layer, part, recording, tally

    slots = 10
    flags = [i % 3 == 0 for i in range(slots + 1)]
    pairs = [1000 * i + 7 for i in range(slots + 1)]

    def tile_lists(where):  # made before the capture: a capture copies nothing from the host
        return [SimpleNamespace(overflow=torch.tensor(f, device=where),
                                offsets=torch.tensor([0, n], dtype=torch.int32, device=where))
                for f, n in zip(flags, pairs)]

    def sequence(lists, on_device):
        def run(name):
            with part(name):
                if on_device:
                    torch.cuda._sleep(PART_SLEEPS[name])
                if name.endswith(".bin"):
                    tally(lists.pop(0))

        with layer("state"):
            pass
        with layer("shadow"):
            for _ in range(slots):
                for name in ("shadow.setup", "shadow.bin", "shadow.raster"):
                    run(name)
        with layer("gbuffer"):
            for name in ("gbuffer.setup", "gbuffer.bin", "gbuffer.raster", "gbuffer.resolve"):
                run(name)

    trace = FrameTrace(device, slots)
    lists = tile_lists(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), recording(trace):
        sequence(lists, True)
    for _ in range(2):
        graph.replay()
        trace.replayed((0.0, 0.0), (0.0, 0.0))
    torch.cuda.synchronize()
    plain = FrameTrace("cpu", slots)
    with recording(plain):
        sequence(tile_lists(torch.device("cpu")), False)
    plain.replayed((0.0, 0.0), (0.0, 0.0))

    check(trace.spans == plain.spans and trace.counter_columns == plain.counter_columns,
          "the captured parts record other intervals or counter columns than the host's")
    check(trace.nodes["part_stamps"] == 3 * slots + 1 + 5, f"{trace.nodes['part_stamps']} part stamps, not 36")
    ring = trace.ring.cpu()
    check(torch.equal(ring[:2] != -1, plain.ring[:1].expand(2, -1) != -1) and bool((ring[2:] == -1).all()),
          "the captured stamps wrote other cells than the host's")
    counter_cells = [c for _, c in trace.counter_columns]
    check(all(torch.equal(ring[k, counter_cells], plain.ring[0, counter_cells]) for k in (0, 1)),
          f"counter cells {ring[0, counter_cells].tolist()}, the host's {plain.ring[0, counter_cells].tolist()}")
    sleep_ms = {name: time_ms(lambda c=c: torch.cuda._sleep(c)) for name, c in PART_SLEEPS.items()}
    counts = {name: sum(1 for n, _, _ in trace.spans if n == name) for name in PART_SLEEPS}
    replays = trace.read()
    check([r.seq for r in replays] == [0, 1], f"replays read {[r.seq for r in replays]}")
    for r in replays:
        check(r.counters == {"raster_overflows": sum(flags), "raster_pairs": sum(pairs)},
              f"replay {r.seq}: counters {r.counters}")
        for name, ms in r.parts_ms.items():
            want = counts[name] * sleep_ms[name]
            check(abs(ms - want) <= counts[name] * STAMP_MS + 0.02 * want,
                  f"replay {r.seq}: part {name} {ms:.4f} ms, its {counts[name]} sleeps {want:.4f} ms")
        layers_ms = r.layer_ms["shadow"] + r.layer_ms["gbuffer"]
        parts_ms = sum(r.parts_ms.values())
        check(layers_ms - 4 * STAMP_MS <= parts_ms <= layers_ms,
              f"replay {r.seq}: parts {parts_ms:.4f} ms against shadow + gbuffer {layers_ms:.4f} ms")
    ov = torch.tensor(True, device=device)
    n = torch.tensor([5], dtype=torch.int32, device=device)
    alone = torch.full((4, MARKS + 4), -1, dtype=torch.int64, device=device)
    seq = torch.zeros((), dtype=torch.int64, device=device)
    report = {"name": "part", "stamps_a_frame": trace.nodes["part_stamps"], "max_abs_err": 0,
              "parts_ms": replays[-1].parts_ms, "sleeps_ms": sleep_ms,
              "layers_ms": {k: replays[-1].layer_ms[k] for k in ("shadow", "gbuffer")},
              "counters": replays[-1].counters}
    report["ms"] = time_ms(lambda: st.stamp(alone, seq, MARKS, False, ov, n, kind="part"))
    report["device_ms"] = device_ms(lambda: st.stamp(alone, seq, MARKS, False, ov, n, kind="part"))
    plain_ring, plain_seq = alone.cpu(), seq.cpu()
    ov_cpu, n_cpu = ov.cpu(), n.cpu()
    t0 = time.perf_counter()
    for _ in range(REPS):
        st.stamp_plain(plain_ring, plain_seq, MARKS, False, ov_cpu, n_cpu)
    report["plain_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    # the sequence read, the flag and the pairs read, a time and two counters written
    report["bound_ms"], report["bound_by"] = bound(8 + 1 + 4 + 3 * 8, 0)
    return report


def phase_bench(device):
    """A main path: ``bench.py``'s three scenes (the default scene with the
    sun animated, the dense field, the chess flagship) at the default
    1920x1080 RenderConfig through ``render_frame_packed``: the capturing
    call on the first row, then ``BENCH_FRAMES`` replays of the next rows
    (uploaded in one stacked copy), timed by CUDA events. Every replayed
    frame must launch one camera raster and at least one shadow raster
    (``kernels.build.LAUNCHES``), and the last frame must be bitwise a
    direct ``render_frame_packed`` of its row."""
    from syzygy_tpu_torch import bench
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame_packed
    from syzygy_tpu_torch.scene.pack import pack_geometry, scene_uses_metallic

    scenes = {"default": bench.default_scene_animated, "dense": bench.dense_scene, "chess": bench.chess_scene}
    report = {"nvidia_smi": nvidia_smi_line(), "scenes": {}, "launches": {"visibility": 0, "depth": 0}}
    for name, make in scenes.items():
        scene, library = make()
        # the bounce multiplies to exactly zero without metallic materials
        config = RenderConfig(width=1920, height=1080, metallic_reflection=scene_uses_metallic(scene, library))
        geometry = pack_geometry(scene, library, device)
        spec, rows = bench.pack_rows(scene, config.width / config.height, BENCH_FRAMES)
        stacked = torch.from_numpy(rows).to(device)
        render_frame_packed(geometry, stacked[0], spec, config)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = LAUNCHES.copy()
        start.record()
        for row in stacked[1:]:
            frame = render_frame_packed(geometry, row, spec, config)
        end.record()
        torch.cuda.synchronize()
        made = LAUNCHES - before
        launches = {kind: made[kind] for kind in ("visibility", "depth")}
        for kind in launches:
            report["launches"][kind] += launches[kind]
        check(tuple(frame.shape) == (config.height, config.width, 3), f"bench {name}: frame shape {tuple(frame.shape)}")
        check(bool(torch.isfinite(frame).all()), f"bench {name}: non-finite values")
        check(launches["visibility"] == BENCH_FRAMES and launches["depth"] >= BENCH_FRAMES,
              f"bench {name}: {BENCH_FRAMES} frames launched {launches}")
        direct = render_frame_packed(pack_geometry(scene, library, device), rows[-1], spec, config)
        bitwise = bool(torch.equal(direct, frame))
        check(bitwise, f"bench {name}: frame {BENCH_FRAMES} differs from a direct render_frame_packed of its row")
        report["scenes"][name] = {
            "ms_per_frame": start.elapsed_time(end) / BENCH_FRAMES, "launches": launches,
            "last_frame_bitwise_direct": bitwise,
        }
    print("bench " + json.dumps(report), flush=True)
    return report


DISPATCH_REPS = 5  # timed replayed frames per scene in phase_dispatch
IDLE_SLOTS_MAPS = (10, 2)  # n_shadow_maps of the dense frames that price the idle shadow slots


def phase_dispatch(device):
    """The frame without a host sync, replayed from its CUDA graph. For
    the default (sun animated), dense, flagship and quirk-exact flagship
    scenes at 1920x1080, under ``torch.cuda.set_sync_debug_mode("error")``:
    the capturing first ``render_frame_packed`` call, a replay (which must
    return while its frame still runs: an event recorded after it has not
    completed), a replay after the row changes, and eager frames
    (``render_frame_eager``) of the same rows, each replay and first call
    bitwise its eager frame; on the default scene also a switch to a
    960x540 config and back. Then, out of that mode, each scene's replayed
    and eager ms/frame (CUDA events), the host ms to enqueue a replay, the
    capture's host seconds, the graph's pool bytes and the peak memory;
    the dense frame at ``n_shadow_maps`` 10 and 2 in turns (10, 2, 2, 10):
    what each idle shadow slot costs. The full-iteration rasters (K3/K4)
    against their plain versions (the flagship and dense cameras and the
    flagship sun), then its main path, with its launches counted from
    just before to just after: flagship frames at
    ``tile_list_capacity=0`` (every raster by full iteration) and dense
    frames at capacity 1 (lists overflow, the device flag takes full
    iteration), each bitwise the default frame."""
    import dataclasses

    from syzygy_tpu_torch import bench
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import (
        RenderConfig,
        captured_frames,
        render_frame_eager,
        render_frame_packed,
    )
    from syzygy_tpu_torch.scene.pack import (
        flatten_frame_params,
        frame_param_spec,
        pack_frame_params,
        pack_geometry,
        upload_frame_params,
    )

    report = {"nvidia_smi": nvidia_smi_line(), "scenes": {}}
    cases = {
        "default": (bench.default_scene_animated, {}, {}),
        "dense": (bench.dense_scene, {}, {}),
        "flagship": (bench.chess_scene, {}, {}),
        "flagship_exact": (bench.chess_scene, EXACT_CONFIG | GOLDEN_STORAGE, {"atlas_f16": False}),
    }
    made = {}
    for name, (make, overrides, pack_kw) in cases.items():
        scene, library = make()
        config = default_scene_config(scene, library, **overrides)
        geometry = pack_geometry(scene, library, device, **pack_kw)
        hosts = [pack_frame_params(scene, config.width / config.height)]
        scene.tick(20.0)  # the default scene's sun moves
        hosts.append(pack_frame_params(scene, config.width / config.height))
        spec = frame_param_spec(hosts[0])
        rows = [flatten_frame_params(h, spec) for h in hosts]
        params = [upload_frame_params(h, device) for h in hosts]  # pageable uploads: before the debug mode
        made[name] = (geometry, config, spec, rows, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            first = render_frame_packed(geometry, rows[0], spec, config)
            first_call_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            render_frame_packed(geometry, rows[0], spec, config)  # the graph's first launch uploads it
            first_replay_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()  # the check's own wait, between two frames
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            replay = render_frame_packed(geometry, rows[0], spec, config)
            issue_ms = (time.perf_counter() - t0) * 1e3
            end = torch.cuda.Event()
            end.record()
            in_flight = not end.query()
            moved = render_frame_packed(geometry, rows[1], spec, config)
            eager = [render_frame_eager(geometry, p, config) for p in params]
            switched = {}
            if name == "default":
                preview = dataclasses.replace(config, width=960, height=540)
                switched["preview"] = render_frame_packed(geometry, rows[1], spec, preview)
                switched["preview_eager"] = render_frame_eager(geometry, params[1], preview)
                switched["back"] = render_frame_packed(geometry, rows[0], spec, config)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        result = {
            "first_call_s": first_call_s, "first_replay_issue_ms": first_replay_ms, "replay_issue_ms": issue_ms,
            "returned_in_flight": in_flight,
            "first_bitwise_eager": bool(torch.equal(first, eager[0])),
            "replay_bitwise_eager": bool(torch.equal(replay, eager[0])),
            "moved_replay_bitwise_eager": bool(torch.equal(moved, eager[1])),
            "row_change_moved_frame": not bool(torch.equal(eager[0], eager[1])),
        }
        if switched:
            result["config_switch_bitwise_eager"] = bool(
                torch.equal(switched["preview"], switched["preview_eager"]) and torch.equal(switched["back"], eager[0])
            )
            check(result["config_switch_bitwise_eager"], f"dispatch {name}: a replay across a config switch differs")
        for key in ("first_bitwise_eager", "replay_bitwise_eager", "moved_replay_bitwise_eager"):
            check(result[key], f"dispatch {name}: {key} is false")
        check(in_flight, f"dispatch {name}: render_frame_packed returned after its frame ended")
        if name == "default":
            check(result["row_change_moved_frame"], "dispatch default: the animated sun did not change the frame")
        graph = [g for g in captured_frames() if g["config"] == config][-1]
        result["capture_s"], result["graph_pool_bytes"] = graph["capture_s"], graph["pool_bytes"]
        result["replay_ms_per_frame"] = time_ms(lambda: render_frame_packed(geometry, rows[0], spec, config), DISPATCH_REPS)
        result["eager_ms_per_frame"] = time_ms(lambda: render_frame_eager(geometry, params[0], config), 2)
        result["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(device))
        report["scenes"][name] = result
        print(f"dispatch {name}: " + json.dumps(result), flush=True)
        del first, replay, moved, eager, switched

    # what an idle shadow slot costs: dense frames at 10 and 2 map slots, in turns
    geometry, config, spec, rows, _ = made["dense"]
    idle = {n: [] for n in IDLE_SLOTS_MAPS}
    for n in IDLE_SLOTS_MAPS + IDLE_SLOTS_MAPS[::-1]:
        cfg = dataclasses.replace(config, n_shadow_maps=n)
        idle[n].append(time_ms(lambda: render_frame_packed(geometry, rows[0], spec, cfg), DISPATCH_REPS))
    many, few = IDLE_SLOTS_MAPS
    report["dense_idle_shadow_slot_ms"] = (statistics.mean(idle[many]) - statistics.mean(idle[few])) / (many - few)
    report["dense_ms_by_n_shadow_maps"] = idle

    # K3/K4 against their plain versions
    chess, chess_lib = flagship()
    fconfig = default_scene_config(chess, chess_lib)
    fgeometry = pack_geometry(chess, chess_lib, device)
    fparams = upload_frame_params(pack_frame_params(chess, fconfig.width / fconfig.height), device)
    fcamera, fsun = raster_setups(fgeometry, fparams, fconfig)
    dense, dense_lib = bench.dense_scene()
    dconfig = default_scene_config(dense, dense_lib, width=960, height=544)
    dparams = upload_frame_params(pack_frame_params(dense, dconfig.width / dconfig.height), device)
    dcamera, _ = raster_setups(made["dense"][0], dparams, dconfig)
    report["full"] = [
        compare_full("flagship_camera_full", fcamera, fconfig.padded_width, fconfig.padded_height, False),
        compare_full("dense_camera_full", dcamera, dconfig.padded_width, dconfig.padded_height, False),
        compare_full("flagship_sun_shadow_full", fsun, fconfig.shadow_dim, fconfig.shadow_dim, True),
    ]

    # the main path of K3/K4: full-iteration and overflowing frames
    fspec = made["flagship"][2]
    frow = made["flagship"][3][0]
    fgeo, fcfg = made["flagship"][0], made["flagship"][1]
    dgeo, dcfg, dspec, drows, _ = made["dense"]
    want_flagship = render_frame_packed(fgeo, frow, fspec, fcfg)
    want_dense = render_frame_packed(dgeo, drows[0], dspec, dcfg)
    torch.cuda.synchronize()
    before = LAUNCHES.copy()
    full_frames = [render_frame_packed(fgeo, frow, fspec, dataclasses.replace(fcfg, tile_list_capacity=0)) for _ in range(2)]
    over_frames = [render_frame_packed(dgeo, drows[0], dspec, dataclasses.replace(dcfg, tile_list_capacity=1)) for _ in range(2)]
    torch.cuda.synchronize()
    report["launches"] = LAUNCHES - before
    report["capacity_0_bitwise_default"] = all(torch.equal(f, want_flagship) for f in full_frames)
    report["capacity_1_bitwise_default"] = all(torch.equal(f, want_dense) for f in over_frames)
    print("dispatch " + json.dumps({k: v for k, v in report.items() if k != "scenes"}), flush=True)
    check(report["capacity_0_bitwise_default"], "dispatch: the tile_list_capacity=0 frame differs from the default frame")
    check(report["capacity_1_bitwise_default"], "dispatch: the overflowing (capacity 1) frame differs from the default frame")
    launches = report["launches"]
    check(launches["visibility_full"] >= 2 and launches["depth_full"] >= 2 and launches["visibility"] >= 2,
          f"dispatch: the full-iteration frames launched {launches}")
    return report


APP_INPUT_SCRIPT = [{"keys": "w"}, {"keys": "d"}, {"cursor": [12, -5]}]
APP_FRAMES = 4
VIEWER_FRAME_LIMIT = 40  # serve(frames=...): above the script's own /frame.png requests


def _direct_frame(scene, library, config, device, geometry=None):
    """``fetch_frame_u8(render_frame_packed(...))`` of a scene's current
    state, as the app and the viewer render it."""
    import numpy as np

    from syzygy_tpu_torch.renderer.frame import render_frame_packed
    from syzygy_tpu_torch.runtime import fetch_frame_u8
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry

    geometry = pack_geometry(scene, library, device) if geometry is None else geometry
    params = pack_frame_params(scene, config.width / config.height)
    spec = frame_param_spec(params)
    return fetch_frame_u8(render_frame_packed(geometry, flatten_frame_params(params, spec), spec, config))


def phase_app(device, width=1920, height=1080):
    """A main path: ``python -m syzygy_tpu_torch.app`` (its ``main``) on the
    card, the chess flagship at 1920x1080, orbiting for 4 frames with a
    3-entry input script, a scene and a config ``--set``, the scene saved
    at the end; its launches counted from just before to just after.
    Its ``--list-properties`` run prints the table. The last PNG
    must be bitwise a direct ``render_frame_packed`` of the saved scene
    after ``load_scene`` (meshes from the flagship's own, instance by
    instance) at the app's config."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from syzygy_tpu_torch.app.__main__ import main as app_main
    from syzygy_tpu_torch.app.scenes import builtin_scene
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.scene.serialize import load_scene, mesh_source_of
    from syzygy_tpu_torch.utils.png import read_png

    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "input.json")
        with open(script, "w") as f:
            json.dump(APP_INPUT_SCRIPT, f)
        saved = os.path.join(tmp, "scene.json")
        args = [
            "--scene", "flagship", "--device", str(device), "--width", str(width), "--height", str(height),
            "--orbit", "--input-script", script, "--out", os.path.join(tmp, "frames"),
            "--set", "camera.fov_degrees=60", "--set", "config.shadow_dim=2048",
        ]
        listing = io.StringIO()
        with contextlib.redirect_stdout(listing):
            app_main(args + ["--list-properties"])
        table = listing.getvalue().splitlines()
        check(table[0].split() == ["property", "value", "default"], f"--list-properties printed {table[:1]}")
        fov = next((line for line in table if line.startswith("cameras[0].fov_degrees")), "")
        check(fov.split()[1:3] == ["60", "70"], f"--list-properties fov row: {fov!r}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        before = LAUNCHES.copy()
        t0 = time.perf_counter()
        result = app_main(args + ["--frames", str(APP_FRAMES), "--save-scene", saved])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {kind: (LAUNCHES - before)[kind] for kind in ("visibility", "depth")}
        peak = int(torch.cuda.max_memory_allocated(device))

        pngs = [read_png(p)[..., :3] for p in result["paths"]]
        check(len(pngs) == APP_FRAMES, f"the app wrote {len(pngs)} frames")
        check(all(p.shape == (height, width, 3) for p in pngs), f"app frame shapes {[p.shape for p in pngs]}")
        check(launches["visibility"] == APP_FRAMES and launches["depth"] >= APP_FRAMES,
              f"the app's {APP_FRAMES} frames launched {launches}")
        check(result["config"].shadow_dim == 2048, "--set config.shadow_dim=2048 did not reach the config")
        check(not np.array_equal(pngs[0], pngs[-1]), "the orbit did not move the camera")

        flagship_scene, library = builtin_scene("flagship")
        loaded = load_scene(saved, mesh_source_of(flagship_scene))
        check(loaded.camera.fov_degrees == 60.0, f"saved fov {loaded.camera.fov_degrees}")
        direct = _direct_frame(loaded, library, result["config"], device)
        bitwise = bool(np.array_equal(direct, pngs[-1]))
    report = {
        "frames": APP_FRAMES,
        "ms_per_frame_host": result["frame_ms"],
        "fps_report": result["fps"],
        "wall_s": wall,
        "launches": launches,
        "peak_mem_bytes": peak,
        "last_frame_bitwise_saved_scene": bitwise,
        "differing_bytes": int((direct != pngs[-1]).sum()),
    }
    print("app " + json.dumps(report), flush=True)
    check(bitwise, f"the app's last frame differs from a direct render of its saved scene at {report['differing_bytes']} bytes")
    return report


class _Viewer:
    """An HTTP client of the viewer on 127.0.0.1 that times each request
    and reads the raster launches each one made."""

    def __init__(self, port):
        import urllib.request

        self.base = f"http://127.0.0.1:{port}"
        self.log = []
        # no proxy from the environment: every request stays on this host
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def request(self, method, path, body=None, label=None):
        import urllib.error
        import urllib.request

        from syzygy_tpu_torch.kernels.build import LAUNCHES

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data, method=method)
        before = LAUNCHES.copy()
        t0 = time.perf_counter()
        try:
            with self.opener.open(req, timeout=120) as r:
                code, payload = r.status, r.read()
        except urllib.error.HTTPError as e:
            code, payload = e.code, e.read()
        ms = (time.perf_counter() - t0) * 1e3
        made = LAUNCHES - before
        entry = {"request": label or f"{method} {path}", "code": code, "ms": ms,
                 "visibility": made["visibility"], "depth": made["depth"]}
        self.log.append(entry)
        return code, payload, entry

    def json(self, method, path, body=None, label=None):
        code, payload, _ = self.request(method, path, body, label)
        return code, json.loads(payload)

    def frame(self, label):
        """GET /frame.png -> (H, W, 3) u8; the entry notes whether the
        request rendered (dispatched) a frame."""
        from syzygy_tpu_torch.utils.png import decode_png

        before = self.json("GET", "/api/stats")[1]["dispatched"]
        code, payload, entry = self.request("GET", "/frame.png", label=label)
        check(code == 200, f"{label}: /frame.png answered {code}: {payload[:200]!r}")
        entry["rendered"] = self.json("GET", "/api/stats")[1]["dispatched"] - before
        image = decode_png(payload)[..., :3]
        entry["size"] = [image.shape[1], image.shape[0]]
        return image

    def drain(self, label, limit=8):
        """/frame.png until the stats owe no frame; the last image."""
        for i in range(limit):
            image = self.frame(f"{label} {i}")
            if not self.json("GET", "/api/stats")[1]["pending"]:
                return image
        raise SmokeFailure(f"{label}: still pending after {limit} requests")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pipeline_saving(scene, library, config, device, rounds=3):
    """What two frames in flight save per interactive request at full
    resolution: host ms of render_png after an input, pipelined against
    synchronous, in turns (off, on, on, off) on one card."""
    from syzygy_tpu_torch.app.serve import _State

    means = {False: [], True: []}
    for pipeline in (False, True, True, False):
        state = _State(scene, library, config, pipeline=pipeline, preview_scale=1, device=device)
        state.render_png()
        times = []
        for _ in range(rounds):
            state.handle_input("w", (0.0, 0.0), 0.05)
            t0 = time.perf_counter()
            state.render_png()
            times.append((time.perf_counter() - t0) * 1e3)
        means[pipeline].append(statistics.mean(times))
    return {
        "sync_ms_per_request": means[False],
        "pipelined_ms_per_request": means[True],
        "saved_ms_per_request": statistics.mean(means[False]) - statistics.mean(means[True]),
    }


def phase_viewer(device, width=1920, height=1080):
    """A main path: the interactive viewer (``app.serve.serve``) on a
    daemon thread, the chess flagship at the default 1920x1080
    RenderConfig on the card with preview_scale 2, driven over HTTP on
    127.0.0.1 by a fixed script (its launches counted from just before
    to just after): the page and a cold frame, three rounds of fly
    input and frames (960x540 previews, pipelined), the drain to the
    full-resolution refinement, property edits and a refused
    ``config.tile_list_capacity -1`` (4xx, config unchanged), the texture
    inspector, two scene loads, and a final drained frame, which must be
    bitwise a direct ``render_frame_packed`` of the viewer's scene and
    config. Every request that rendered must have launched the camera
    raster (once per frame it rendered) and a shadow raster."""
    import threading

    import numpy as np

    from syzygy_tpu_torch.app.serve import serve
    from syzygy_tpu_torch.kernels.build import LAUNCHES

    scene, library = flagship()
    config = default_scene_config(scene, library, width=width, height=height)
    port = _free_port()
    out = {}
    thread = threading.Thread(
        target=lambda: out.update(state=serve(
            scene, library, config, port=port, frames=VIEWER_FRAME_LIMIT, preview_scale=2, device=device
        )),
        daemon=True,
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    first = LAUNCHES.copy()
    thread.start()
    v = _Viewer(port)
    for _ in range(600):  # the server is up once it answers the page
        try:
            code, page, _ = v.request("GET", "/", label="page")
            break
        except OSError:
            time.sleep(0.05)
    else:
        raise SmokeFailure("the viewer did not come up")
    check(code == 200 and b"drawSpark" in page, "GET / did not serve the viewer page")

    sizes = {"cold": v.frame("cold frame").shape}
    for i in range(3):
        code, _ = v.json("POST", "/api/input", {"keys": "w", "dt": 0.12}, label=f"input {i}")
        check(code == 200, f"/api/input answered {code}")
        sizes[f"input {i}"] = v.frame(f"frame after input {i}").shape
    sizes["refined"] = v.drain("refine").shape
    full = (height, width, 3)
    check(sizes["cold"] == full and sizes["refined"] == full, f"frame sizes {sizes}")
    previews = sum(1 for e in v.log if e.get("size") == [width // 2, height // 2])
    check(previews >= 2, f"only {previews} preview frames of {width // 2}x{height // 2}")

    edits = {}
    for path, value in (("camera.fov_degrees", "60"), ("config.n_shadow_maps", "4"), ("config.tile_list_capacity", "-1")):
        edits[path] = v.json("POST", "/api/set", {"path": path, "value": value}, label=f"set {path}")
    check(edits["camera.fov_degrees"] == (200, {"value": "60"}), f"fov edit: {edits['camera.fov_degrees']}")
    check(edits["config.n_shadow_maps"] == (200, {"value": "4"}), f"n_shadow_maps edit: {edits['config.n_shadow_maps']}")
    refused = edits["config.tile_list_capacity"]
    check(400 <= refused[0] < 500 and "error" in refused[1], f"config.tile_list_capacity=-1 answered {refused}")
    rows = {p["path"]: p["value"] for p in v.json("GET", "/api/properties")[1]}
    check(rows["config.tile_list_capacity"] == "448" and rows["config.n_shadow_maps"] == "4",
          f"the refused edit changed the config: tile_list_capacity {rows['config.tile_list_capacity']}")

    code, textures = v.json("GET", "/api/textures")
    check(code == 200 and textures, "no textures listed")
    from urllib.parse import quote

    from syzygy_tpu_torch.utils.png import decode_png

    code, payload, _ = v.request("GET", "/texture.png?name=" + quote(textures[0]["name"]), label="texture")
    tex = decode_png(payload)
    check(code == 200 and tex.shape[:2] == (textures[0]["h"], textures[0]["w"]), f"texture.png: {code} {tex.shape}")

    for name in ("chessboard", "flagship"):
        code, loaded = v.json("POST", "/api/load", {"path": name, "merge": False}, label=f"load {name}")
        check(code == 200 and loaded == {"scene": name}, f"/api/load {name}: {code} {loaded}")
    final = v.drain("final")
    code, stats = v.json("GET", "/api/stats")
    check(final.shape == full, f"final frame {final.shape}")
    launches = {kind: (LAUNCHES - first)[kind] for kind in ("visibility", "depth")}
    peak = int(torch.cuda.max_memory_allocated(device))

    # stop the viewer: cached frames up to its frame limit
    for _ in range(VIEWER_FRAME_LIMIT):
        if not thread.is_alive():
            break
        try:
            v.request("GET", "/frame.png", label="rest")
        except OSError:
            break
        thread.join(timeout=0.05)
    thread.join(timeout=30)
    check(not thread.is_alive(), "the viewer did not stop")
    state = out["state"]
    direct = _direct_frame(state.scene, state.library, state.config, device, geometry=state.geometry)
    bitwise = bool(np.array_equal(direct, final))

    rendered = [e for e in v.log if e.get("rendered")]
    for e in rendered:
        check(e["visibility"] >= e["rendered"] and e["depth"] >= 1,
              f"{e['request']} rendered {e['rendered']} frame(s) and launched {e['visibility']}/{e['depth']}")
    saving = _pipeline_saving(*flagship(), config, device)
    report = {
        "requests": [e for e in v.log if e["request"] != "rest"],
        "rendered_requests": len(rendered),
        "launches": launches,
        "peak_mem_bytes": peak,
        "fps_report": stats["fps"],
        "final_bitwise_direct": bitwise,
        "differing_bytes": int((direct != final).sum()),
        "two_frames_in_flight": saving,
    }
    print("viewer " + json.dumps(report), flush=True)
    check(len(rendered) >= 6, f"only {len(rendered)} requests rendered a frame")
    check(bitwise, f"the final viewer frame differs from a direct render at {report['differing_bytes']} bytes")
    return report


def phase_native():
    """The port's C++ host core (``syzygy_tpu_torch/native.py``), built
    with ``g++`` from ``csrc/szg_native.cpp`` on this host, then
    ``Scene.shadow_bounds`` on ``NATIVE_SEEDS`` seeded rotated-caster
    versions of the default scene and of the chess flagship: through the
    C++ path (counted by the library's call counter) and through the numpy
    path, held together at the reference's 1e-4
    (``tests/test_fallbacks.py:15-21``), relative where a bound exceeds 1
    (the default floor reaches 2,000 m, where one f32 step is 2.4e-4); it
    counts the bitwise vectors."""
    import numpy as np

    from syzygy_tpu_torch import native
    from syzygy_tpu_torch.assets.chess import flagship_scene
    from syzygy_tpu_torch.scene.scene import default_scene

    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    check(native.available(), "the port's C++ host core did not build or load")
    report = {"build_s": build_s, "library": os.path.relpath(path, ROOT), "scenes": {}}
    available = native.available
    for name, make in (("default", default_scene), ("flagship", flagship_scene)):
        scene, _ = make()
        native.CALLS.reset()
        vectors = bitwise = 0
        worst = worst_rel = 0.0
        for seed in range(NATIVE_SEEDS):
            rng = np.random.default_rng(seed)
            for instance in scene.geometry:
                for transform in instance.transforms:
                    transform.euler_angles[:] = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
            compiled = scene.shadow_bounds()
            native.available = lambda: False
            try:
                plain = scene.shadow_bounds()
            finally:
                native.available = available
            for a, b in zip(compiled, plain):
                vectors += 1
                bitwise += bool(np.array_equal(a, b))
                worst = max(worst, float(np.abs(a - b).max()))
                worst_rel = max(worst_rel, float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max()))
        calls = native.CALLS.shadow_bounds
        report["scenes"][name] = {"vectors": vectors, "bitwise": bitwise, "max_abs": worst, "max_rel": worst_rel,
                                  "native_calls": calls}
        check(calls == NATIVE_SEEDS, f"native {name}: Scene.shadow_bounds took the C++ path {calls} of {NATIVE_SEEDS} times")
        check(worst_rel <= 1e-4, f"native {name}: C++ vs numpy shadow bounds differ by {worst_rel} (relative)")
    print(f"native: build {build_s:.2f} s", flush=True)
    print("native " + json.dumps(report), flush=True)
    return report


def phase_sharded(device, width=1920, height=1080):
    """``parallel/sharding.py`` on the card, each case a main path (each
    rank renders its batch twice, ``render_case(warm=True)``: the first
    render timed apart; rank 0's raster launches counted over the
    second), each batch bitwise the direct
    ``render_frame`` of its frames: world size 1 in this process, (dp=1,
    sp=1) on the chess flagship (``ranks.backend_for``'s backend: NCCL);
    then two ranks of a gloo group, started once for both cases
    (``render_cases``), both on ``cuda:0`` (NCCL refuses two ranks on one
    card): (1, 2) on the flagship (1088 rows pad to 1152, two blocks of
    576), and (2, 1) on the default scene, two frames 20 s of sun apart,
    one per rank."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from syzygy_tpu_torch.parallel import ranks
    from syzygy_tpu_torch.parallel.dryrun import case_params, render_case
    from syzygy_tpu_torch.renderer.frame import render_frame
    from syzygy_tpu_torch.scene.pack import pack_geometry, upload_frame_params

    def direct(scene_name, frames, dt):
        scene, library, params = case_params(scene_name, frames, dt, width / height)
        config = default_scene_config(scene, library, width=width, height=height)
        geometry = pack_geometry(scene, library, device)
        images = torch.stack([render_frame(geometry, upload_frame_params(p, device), config) for p in params])
        return images.cpu(), {"metallic_reflection": config.metallic_reflection}

    cases, launches = [], {"visibility": 0, "depth": 0}

    def record(mesh, backend, scene_name, results, want):
        first = results[0]
        for rank, result in enumerate(results):
            check(torch.equal(result["images"], want), f"sharded {mesh} rank {rank}: differs from render_frame")
        check(first["launches"]["visibility"] >= 1 and first["launches"]["depth"] >= 1,
              f"sharded {mesh}: rank 0 launched {first['launches']}")
        for kind in launches:
            launches[kind] += first["launches"][kind]
        case = {
            "mesh": mesh, "ranks": len(results), "backend": backend, "scene": scene_name,
            "frames": int(want.shape[0]), "ms_per_frame": [r["ms"] / (want.shape[0] // mesh[0]) for r in results],
            "first_render_ms_per_frame": [r["first_ms"] / (want.shape[0] // mesh[0]) for r in results],
            "rank0_launches": first["launches"], "bitwise_render_frame": True,
        }
        cases.append(case)
        print(f"sharded {mesh} on {len(results)} {backend} rank(s), {scene_name} {width}x{height}: "
              f"rank 0 {case['ms_per_frame'][0]:.3f} ms/frame (first render "
              f"{case['first_render_ms_per_frame'][0]:.3f}), launches {first['launches']}, bitwise render_frame",
              flush=True)

    flagship_want, flagship_cfg = direct("flagship", 1, 1.0 / 60.0)
    backend = ranks.backend_for("cuda", 1)
    with tempfile.TemporaryDirectory(prefix="szg_world1_") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT))
        try:
            one = render_case(1, 1, width, height, 1, device="cuda", scene="flagship", config=flagship_cfg, warm=True)
        finally:
            dist.destroy_process_group()
    record((1, 1), backend, "flagship", [one], flagship_want)

    default_want, default_cfg = direct("default", 2, SHARDED_DEFAULT_DT)
    check(not torch.equal(default_want[0], default_want[1]), "sharded (2, 1): the two frames are the same")
    spawned = (
        ((1, 2), "flagship", flagship_want, flagship_cfg, 1.0 / 60.0),
        ((2, 1), "default", default_want, default_cfg, SHARDED_DEFAULT_DT),
    )
    per_rank = ranks.run(
        2, "syzygy_tpu_torch.parallel.dryrun:render_cases",
        dict(cases=[dict(dp=mesh[0], sp=mesh[1], width=width, height=height, frames=mesh[0], scene=scene_name,
                         dt=dt, config=cfg, warm=True) for mesh, scene_name, _, cfg, dt in spawned],
             device="cuda"),
        device="cuda", timeout=SHARDED_TIMEOUT,
    )
    for k, (mesh, scene_name, want, _, _) in enumerate(spawned):
        results = [r[k] for r in per_rank]
        check(all(r["device"] == "cuda:0" for r in results), f"sharded {mesh}: ranks on {[r['device'] for r in results]}")
        record(mesh, ranks.backend_for("cuda", 2), scene_name, results, want)
    report = {"cases": cases, "launches": launches}
    print("sharded " + json.dumps(report), flush=True)
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import syzygy_tpu_torch
        from syzygy_tpu_torch.kernels import build
    except ImportError as e:
        print(f"FAIL: the syzygy_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1
    if not os.path.abspath(syzygy_tpu_torch.__file__).startswith(ROOT + os.sep):
        print("FAIL: syzygy_tpu_torch was imported from outside this checkout", file=sys.stderr)
        return 1

    from syzygy_tpu_torch.scene.scene import default_scene

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(nvidia_smi_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.2f} s", flush=True)
        return out

    stamp_launches, part_launches, lighting_launches = {}, {}, {}
    scattering_launches, sky_launches = {}, {}

    def main_path(name, fn, *args, **kwargs):
        """``timed``, with the stamp, part stamp, lighting, scattering and
        sky launches of the frames it runs (a replay launches those its
        graph holds). A path that replays a stamped frame must replay its
        part stamps too."""
        before = build.LAUNCHES.copy()
        out = timed(name, fn, *args, **kwargs)
        made = build.LAUNCHES - before
        stamp_launches[name] = made["stamp"]
        part_launches[name] = made["part"]
        lighting_launches[name] = made["lighting"]
        scattering_launches[name] = made["scattering"]
        sky_launches[name] = made["sky"]
        print(f"phase {name}: {stamp_launches[name]} stamp launches, {part_launches[name]} part stamp launches, "
              f"{lighting_launches[name]} lighting launches, "
              f"{scattering_launches[name]} scattering launches over {made['scattering_rays']} rays, "
              f"{sky_launches[name]} sky launches", flush=True)
        check(part_launches[name] > 0 or stamp_launches[name] == 0,
              f"phase {name}: {stamp_launches[name]} stamp launches but no part stamp")
        return out

    try:
        timed("build", build.build)
        for name in build.SOURCES:
            print(f"ptxas {name}: {build.ptxas_report(name)}", flush=True)
        timed("native", phase_native)
        compare = timed("compare_raster", phase_compare_raster, device)
        gather_report = timed("compare_gather", phase_compare_gather, device)[0]
        stamp_report = timed("compare_stamp", phase_compare_stamp, device)
        lighting_reports = timed("compare_lighting", phase_compare_lighting, device)
        scattering_reports = timed("compare_scattering", phase_compare_scattering, device)
        sky_reports = timed("compare_sky", phase_compare_sky, device)
        scene, library = default_scene()
        scene.tick(0.0)
        default_frames = main_path("frames_default", phase_frames, "default", scene, library, device, n_frames=4,
                                   dt_seconds=20.0)
        chess, chess_lib = flagship()
        flagship_frames = main_path("frames_flagship", phase_frames, "flagship", chess, chess_lib, device,
                                    n_frames=3)
        bench_report = main_path("bench", phase_bench, device)
        dispatch_report = main_path("dispatch", phase_dispatch, device)
        exact_frames = main_path("flagship_1080p", phase_flagship_1080p, device)
        gather_launches = timed("gather_bench", phase_gather_bench)
        timed("golden", phase_golden, device)
        timed("flagship_golden", phase_flagship_golden, device)
        timed("feature_frames", phase_feature_frames, device)
        app_report = main_path("app", phase_app, device)
        viewer_report = main_path("viewer", phase_viewer, device)
        sharded_report = timed("sharded", phase_sharded, device)
    except (SmokeFailure, RuntimeError, ValueError, IndexError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: {time.perf_counter() - start:.2f} s; phases " + json.dumps(seconds), flush=True)

    by_name = {r["name"]: r for r in compare}
    src = "syzygy_tpu_torch/csrc/raster.cu"

    def raster_entry(name, replaces, kind, timed, compared):
        r = by_name[timed]
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(
                f["launches"].get(kind, 0)
                for f in (
                    default_frames, flagship_frames, bench_report, exact_frames, app_report, viewer_report,
                    sharded_report, dispatch_report,
                )
            ),
            "max_abs_err": max(by_name[n]["max_abs_err"] for n in compared),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        }

    full = {r["name"]: r for r in dispatch_report["full"]}

    def full_entry(name, replaces, kind, timed):
        r = full[timed]
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": dispatch_report["launches"][kind],
            "max_abs_err": max(f["max_abs_err"] for f in full.values() if ("sun" in f["name"]) == (kind == "depth_full")),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        }

    kernels = [
        raster_entry(
            "raster_visibility", "syzygy_tpu/kernels/raster.py:1014", "visibility", "flagship_camera",
            ("default_camera", "dense_camera", "flagship_camera", "flagship_camera_rows"),
        ),
        raster_entry(
            "raster_depth", "syzygy_tpu/kernels/raster.py:1005", "depth", "flagship_sun_shadow",
            ("default_sun_shadow", "dense_sun_shadow", "flagship_sun_shadow", "flagship_sun_shadow_4096",
             "flagship_camera_rows_depth"),
        ),
        full_entry("raster_visibility_full", "syzygy_tpu/kernels/raster.py:808", "visibility_full", "flagship_camera_full"),
        full_entry("raster_depth_full", "syzygy_tpu/kernels/raster.py:799", "depth_full", "flagship_sun_shadow_full"),
        {
            "name": "lane_gather", "route": "cuda", "source": "syzygy_tpu_torch/csrc/gather.cu",
            "replaces": "tools/gather_bench.py:246", "launches": gather_launches,
            "max_abs_err": gather_report["max_abs_err"], "ms": gather_report["ms"],
            "plain_ms": gather_report["plain_ms"], "bound_ms": gather_report["bound_ms"],
            "bound_by": gather_report["bound_by"], "library_ms": gather_report["library_ms"],
        },
        {
            "name": "stamp", "route": "cuda", "source": "syzygy_tpu_torch/csrc/stamp.cu",
            "replaces": None, "launches": sum(stamp_launches.values()),
            "max_abs_err": stamp_report["max_abs_err"], "ms": stamp_report["ms"],
            "plain_ms": stamp_report["plain_ms"], "bound_ms": stamp_report["bound_ms"],
            "bound_by": stamp_report["bound_by"], "library_ms": None,
        },
        {
            "name": "part", "route": "cuda", "source": "syzygy_tpu_torch/csrc/stamp.cu",
            "replaces": None, "launches": sum(part_launches.values()),
            "launches_by_path": part_launches,
            "max_abs_err": stamp_report["part"]["max_abs_err"], "ms": stamp_report["part"]["ms"],
            "device_ms": stamp_report["part"]["device_ms"], "plain_ms": stamp_report["part"]["plain_ms"],
            "bound_ms": stamp_report["part"]["bound_ms"], "bound_by": stamp_report["part"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "lighting", "route": "cuda", "source": "syzygy_tpu_torch/csrc/lighting.cu",
            "replaces": None, "launches": sum(lighting_launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in lighting_reports), "ms": lighting_reports[0]["ms"],
            "plain_ms": lighting_reports[0]["plain_ms"], "bound_ms": lighting_reports[0]["bound_ms"],
            "bound_by": lighting_reports[0]["bound_by"], "library_ms": None,
            "cases": [{k: r[k] for k in ("name", "slots", "ms", "plain_ms", "bound_ms")} for r in lighting_reports],
        },
        {
            "name": "scattering", "route": "cuda", "source": "syzygy_tpu_torch/csrc/scattering.cu",
            "replaces": None, "launches": sum(scattering_launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in scattering_reports), "ms": scattering_reports[-2]["ms"],
            "plain_ms": scattering_reports[-2]["plain_ms"], "bound_ms": scattering_reports[-2]["bound_ms"],
            "bound_by": scattering_reports[-2]["bound_by"], "library_ms": None,
            "cases": [{k: r[k] for k in ("name", "rays", "ms", "plain_ms", "bound_ms")} for r in scattering_reports],
        },
        {
            "name": "sky", "route": "cuda", "source": "syzygy_tpu_torch/csrc/sky.cu",
            "replaces": None, "launches": sum(sky_launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in sky_reports), "ms": sky_reports[-1]["ms"],
            "plain_ms": sky_reports[-1]["plain_ms"], "bound_ms": sky_reports[-1]["bound_ms"],
            "bound_by": sky_reports[-1]["bound_by"], "library_ms": None,
            "cases": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms")} for r in sky_reports],
        },
    ]
    if any(k["launches"] < 1 for k in kernels):
        print("FAIL: a kernel of the main paths was never launched", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
