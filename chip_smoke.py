#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``syzygy_tpu_torch/csrc/*.cu`` (the raster
   and the lane gather, one ``nvcc`` each, concurrently), with ptxas's
   register report;
3. each kernel vs its plain torch version on the card, timed, beside its
   bound: the raster on the default scene's 1920x1088 camera and 1024^2
   sun map, the 254k-triangle dense sphere field's 960x544 camera and
   1024^2 sun map, and the chess flagship's 1920x1088 camera and 1024^2
   sun map; the lane gather at S = 1,999,872 on the gather bench's seeded
   inputs (and ``torch.take`` as a yardstick);
4. the main paths, each with the launch counters set to 0 just before and
   read just after: 8 frames of the default scene and 6 of the chess
   flagship through ``renderer.frame.render_frame`` at the default
   1920x1080 RenderConfig (CUDA-event ms/frame, peak memory), and the
   port's gather bench (``tools/gather_bench.py``, g1-g7) at its default
   size;
5. parity at the golden configs, card against the CPU port and against
   the JAX package's goldens: the default scene at 256x128
   (``default_scene_256x128.png``) and the flagship at 512x288
   (``flagship_512x288.npz``, visibility ``flagship_vis_512x288.npz``).

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

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
GOLDEN = os.path.join(GOLDEN_DIR, "default_scene_256x128.png")
FLAGSHIP_FRAME = os.path.join(GOLDEN_DIR, "flagship_512x288.npz")
FLAGSHIP_VIS = os.path.join(GOLDEN_DIR, "flagship_vis_512x288.npz")
FLAGSHIP_EYE, FLAGSHIP_TARGET = (13.0, -8.0, -14.0), (0.0, -1.0, 0.0)  # bench.py:264-271

# published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# csrc/raster.cu per (pixel, slot): 2 mul + 4 add/sub + 2 fma (2 each) + 6 compares
RASTER_OPS_PER_TEST = 16
REPS = 20

# tolerance classes of the raster (tests/test_raster.py rules)
EDGE_TOL = 1e-4  # an id may differ only this close (barycentric) to an edge
DEPTH_TOL = 1e-5
BARY_TOL = 1e-5


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


def device_ms(fn, reps: int = REPS) -> float:
    """Mean summed device time (ms) of the kernels ``fn`` launches, from
    ``torch.profiler``'s CUDA activity over ``reps`` calls: the kernels
    alone, without the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "the profiler saw no kernel")
    return sum(e.time_range.elapsed_us() for e in kernels) / 1000.0 / reps


def default_scene_config(scene, library, **overrides):
    import dataclasses

    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.pack import scene_uses_metallic

    config = RenderConfig(**overrides)
    return dataclasses.replace(
        config, metallic_reflection=scene_uses_metallic(scene, library)
    )


def look_at(scene, eye, target):
    from syzygy_tpu_torch.math.geometry import eulers_from_forward

    fwd = torch.tensor(target, dtype=torch.float32, device="cpu") - torch.tensor(eye, dtype=torch.float32, device="cpu")
    scene.camera.position = tuple(float(x) for x in eye)
    scene.camera.euler_angles = tuple(float(x) for x in eulers_from_forward(fwd))


def flagship():
    """The chess flagship through the port's glTF path, framed as
    ``bench.py:264-271`` frames it."""
    from syzygy_tpu_torch.assets.chess import flagship_scene

    scene, library = flagship_scene()
    scene.tick(0.0)
    look_at(scene, FLAGSHIP_EYE, FLAGSHIP_TARGET)
    return scene, library


def raster_setups(geometry, params, config):
    """The camera and sun-shadow triangle setups exactly as the frame
    builds them."""
    from syzygy_tpu_torch.kernels.raster import setup_triangles
    from syzygy_tpu_torch.kernels.resolve import transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4, matvec
    from syzygy_tpu_torch.scene.pack import prepare_frame_state

    state = prepare_frame_state(params)
    cam = state.camera
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, matmul4(cam.projection, cam.view)
    )
    camera = setup_triangles(
        clip, geometry.triangles, geometry.tri_valid, config.render_width, config.render_height,
        cull_keep_sign=1, grid_width=config.padded_width, grid_height=config.padded_height,
    )
    sun = state.directional_lights
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    corners = world_h[geometry.triangles.long()]
    shadow = setup_triangles(
        None, geometry.triangles, geometry.tri_valid & geometry.tri_casts_shadow,
        config.shadow_dim, config.shadow_dim, cull_keep_sign=-1,
        corner_clip=matvec(matmul4(sun.projection[0], sun.view[0]), corners),
    )
    return camera, shadow


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


def raster_bound(setup, lists, height, width, depth_only) -> tuple[float, str]:
    """Bytes: each listed slot's 12-float row, each list entry and offset,
    and the outputs (4 B/px depth; 16 B/px visibility) once; operations:
    the per-(pixel, slot) test over every pixel of each listed (tile,
    slot) pair."""
    from syzygy_tpu_torch.kernels.raster import TILE_H, TILE_W

    pairs = int(lists.slots.numel())
    listed = int(torch.unique(lists.slots).numel()) if pairs else 0
    n_bytes = listed * 48 + pairs * 4 + int(lists.offsets.numel()) * 4 + height * width * (4 if depth_only else 16)
    return bound(n_bytes, pairs * TILE_H * TILE_W * RASTER_OPS_PER_TEST)


def compare_raster(name, setup, width, height, depth_only):
    """Kernel vs rasterize_plain on the same inputs; returns a report."""
    from syzygy_tpu_torch.kernels import raster

    lists = raster.bin_triangles(setup.coeffs, height, width)
    kern = raster.rasterize(setup, width, height, depth_only=depth_only, lists=lists)
    torch.cuda.synchronize()
    plain = raster.rasterize_plain(setup, width, height, depth_only=depth_only, lists=lists)
    torch.cuda.synchronize()

    report = {"name": name, "shape": [height, width], "pairs": int(lists.slots.numel())}
    if depth_only:
        err = float((kern.depth - plain.depth).abs().max())
        check(err <= DEPTH_TOL, f"{name}: depth differs by {err}")
        report["max_abs_err"] = err
        report["covered_px"] = int((kern.depth > 0).sum())
    else:
        differ = kern.tri != plain.tri
        n_diff = int(differ.sum())
        if n_diff:
            # an id may flip only at a knife edge (or an exact depth tie)
            ys, xs = torch.nonzero(differ, as_tuple=True)
            worst = max(edge_distance(setup, ys, xs, ids) for ids in (kern.tri[ys, xs], plain.tri[ys, xs]))
            check(worst < EDGE_TOL, f"{name}: {n_diff} id flips, up to {worst} from an edge")
        same = ~differ
        err = max(
            float((kern.depth - plain.depth)[same].abs().max()),
            float((kern.b0 - plain.b0)[same].abs().max()),
            float((kern.b1 - plain.b1)[same].abs().max()),
        )
        check(err <= max(DEPTH_TOL, BARY_TOL), f"{name}: depth/barycentrics differ by {err}")
        report["id_flips"] = n_diff
        report["max_abs_err"] = err
        report["covered_px"] = int((kern.tri >= 0).sum())

    # the kernel alone (lists prebuilt) and the plain version
    report["ms"] = time_ms(lambda: raster.rasterize(setup, width, height, depth_only=depth_only, lists=lists))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    raster.rasterize_plain(setup, width, height, depth_only=depth_only, lists=lists)
    end.record()
    torch.cuda.synchronize()
    report["plain_ms"] = start.elapsed_time(end)
    report["bound_ms"], report["bound_by"] = raster_bound(setup, lists, height, width, depth_only)
    report["library_ms"] = None  # no single PyTorch call computes a raster
    print("compare " + json.dumps(report), flush=True)
    return report


def phase_compare_raster(device):
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from syzygy_tpu_torch.scene.scene import default_scene, dense_sphere_field

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

    dense, dense_lib = dense_sphere_field()
    look_at(dense, (18.0, -16.0, -22.0), (0.0, -6.0, 0.0))
    dgeometry, dense_reports = both("dense", dense, dense_lib, width=960, height=544)
    check(int(dgeometry.tri_valid.sum()) == 253_952, "dense field is not 253,952 triangles")

    chess, chess_lib = flagship()
    fgeometry, flagship_reports = both("flagship", chess, chess_lib)
    check(int(fgeometry.tri_valid.sum()) == 14_316, "the flagship is not 14,316 triangles")
    return reports + dense_reports + flagship_reports


def phase_compare_gather(device):
    """lane_gather vs its plain version at the bench's default size, on
    the bench's seeded inputs."""
    from syzygy_tpu_torch.kernels import gather
    from syzygy_tpu_torch.tools import gather_bench as bench

    n = bench.sample_count(2.0)
    d = bench.bench_inputs(n)
    flat = torch.from_numpy(d["lut"][:, :, 0].reshape(-1).copy()).to(device)
    idx = gather.lut_index(torch.from_numpy(d["u"]).to(device), torch.from_numpy(d["v"]).to(device), bench.H, bench.W)
    kern = gather.lane_gather(flat, idx)
    plain = gather.lane_gather_plain(flat, idx)
    torch.cuda.synchronize()
    err = float((kern - plain).abs().max())
    check(err == 0.0, f"lane_gather differs from its plain version by {err}")
    idx64 = idx.long()
    report = {
        "name": "lane_gather", "samples": n, "max_abs_err": err,
        "ms": time_ms(lambda: gather._launch(flat, idx)),  # the kernel alone, inputs checked above
        "plain_ms": time_ms(lambda: gather.lane_gather_plain(flat, idx)),
        "library_ms": time_ms(lambda: torch.take(flat, idx64)),  # a yardstick; the port never calls it
        "device_ms": device_ms(lambda: gather._launch(flat, idx)),
        "library_device_ms": device_ms(lambda: torch.take(flat, idx64)),
    }
    report["bound_ms"], report["bound_by"] = bound(4 * n + 4 * n + 4 * flat.numel(), 0)
    print("compare " + json.dumps(report), flush=True)
    return report


def phase_frames(name, scene, library, device, n_frames, warmup=2, dt_seconds=0.0):
    """A main path: ``n_frames`` frames through render_frame at the default
    1920x1080 RenderConfig, the raster launch counts set to 0 before and
    read after."""
    from syzygy_tpu_torch.kernels.raster import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    config = default_scene_config(scene, library)
    geometry = pack_geometry(scene, library, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    times, counts = [], []
    LAUNCHES.reset()
    for frame in range(n_frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = (LAUNCHES.visibility, LAUNCHES.depth)
        start.record()
        params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
        image = render_frame(geometry, params, config)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        counts.append((LAUNCHES.visibility - before[0], LAUNCHES.depth - before[1]))
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
        "launches": {"visibility": LAUNCHES.visibility, "depth": LAUNCHES.depth},
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated(device)),
        "resolution": [config.width, config.height],
    }
    print("frames " + json.dumps(result), flush=True)
    return result


def phase_gather_bench():
    """The port's gather bench at its default size, the lane gather's
    launch count set to 0 before and read after."""
    from syzygy_tpu_torch.kernels import gather
    from syzygy_tpu_torch.tools import gather_bench as bench

    gather.LAUNCHES.reset()
    result = bench.main([])
    launches = gather.LAUNCHES.lane_gather
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

    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from syzygy_tpu_torch.scene.scene import default_scene
    from syzygy_tpu_torch.utils.png import read_png

    scene, library = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    look_at(scene, (18.0, -16.0, -22.0), (0.0, -6.0, 0.0))
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
            setup, _ = raster_setups(geometry, params, config)
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
    try:
        t0 = time.perf_counter()
        build.build()
        print(f"build: {time.perf_counter() - t0:.2f} s (all sources, concurrently)", flush=True)
        for name in build.SOURCES:
            print(f"ptxas {name}: {build.ptxas_report(name)}", flush=True)
        compare = phase_compare_raster(device)
        gather_report = phase_compare_gather(device)
        scene, library = default_scene()
        scene.tick(0.0)
        default_frames = phase_frames("default", scene, library, device, n_frames=8, dt_seconds=20.0)
        chess, chess_lib = flagship()
        flagship_frames = phase_frames("flagship", chess, chess_lib, device, n_frames=6)
        gather_launches = phase_gather_bench()
        phase_golden(device)
        phase_flagship_golden(device)
    except (SmokeFailure, RuntimeError, ValueError, IndexError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    by_name = {r["name"]: r for r in compare}
    src = "syzygy_tpu_torch/csrc/raster.cu"

    def raster_entry(name, replaces, kind, timed, compared):
        r = by_name[timed]
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": default_frames["launches"][kind] + flagship_frames["launches"][kind],
            "max_abs_err": max(by_name[n]["max_abs_err"] for n in compared),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        }

    kernels = [
        raster_entry(
            "raster_visibility", "syzygy_tpu/kernels/raster.py:1014", "visibility", "flagship_camera",
            ("default_camera", "dense_camera", "flagship_camera"),
        ),
        raster_entry(
            "raster_depth", "syzygy_tpu/kernels/raster.py:1005", "depth", "flagship_sun_shadow",
            ("default_sun_shadow", "dense_sun_shadow", "flagship_sun_shadow"),
        ),
        {
            "name": "lane_gather", "route": "cuda", "source": "syzygy_tpu_torch/csrc/gather.cu",
            "replaces": "tools/gather_bench.py:246", "launches": gather_launches,
            "max_abs_err": gather_report["max_abs_err"], "ms": gather_report["ms"],
            "plain_ms": gather_report["plain_ms"], "bound_ms": gather_report["bound_ms"],
            "bound_by": gather_report["bound_by"], "library_ms": gather_report["library_ms"],
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
