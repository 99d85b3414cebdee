#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA raster kernel from ``syzygy_tpu_torch/csrc/raster.cu``;
3. kernel vs its plain torch version on the card: the default scene's
   1920x1088 camera raster and its 1024^2 sun shadow map, and the
   254k-triangle dense sphere field's 960x544 camera raster and 1024^2 sun
   shadow map;
4. the main path: 8 frames of the default scene through
   ``renderer.frame.render_frame`` at the default 1920x1080 RenderConfig,
   the sun ticking, with the kernel's launch counters and CUDA-event
   ms/frame;
5. the default scene at the golden config (256x128) on the card and on the
   CPU through the port, against each other and against
   ``tests/goldens/default_scene_256x128.png``.

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
GOLDEN = os.path.join(ROOT, "tests", "goldens", "default_scene_256x128.png")

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
            px = xs.double() + 0.5
            py = ys.double() + 0.5
            worst = 0.0
            for ids in (kern.tri[ys, xs], plain.tri[ys, xs]):
                c = setup.coeffs[ids.clamp(min=0).long()].double()
                b0 = c[:, 0] + c[:, 1] * px + c[:, 2] * py
                b1 = c[:, 3] + c[:, 4] * px + c[:, 5] * py
                edge = torch.minimum(torch.minimum(b0.abs(), b1.abs()), (1 - b0 - b1).abs())
                edge = torch.where(ids >= 0, edge, torch.zeros_like(edge))
                worst = max(worst, float(edge.max()))
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

    # time the kernel alone (lists prebuilt) and the plain version
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    raster.rasterize(setup, width, height, depth_only=depth_only, lists=lists)
    torch.cuda.synchronize()
    reps = 20
    start.record()
    for _ in range(reps):
        raster.rasterize(setup, width, height, depth_only=depth_only, lists=lists)
    end.record()
    torch.cuda.synchronize()
    report["ms"] = start.elapsed_time(end) / reps
    start.record()
    raster.rasterize_plain(setup, width, height, depth_only=depth_only, lists=lists)
    end.record()
    torch.cuda.synchronize()
    report["plain_ms"] = start.elapsed_time(end)
    return report


def phase_compare(device):
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from syzygy_tpu_torch.scene.scene import default_scene, dense_sphere_field

    scene, library = default_scene()
    scene.tick(0.0)
    config = default_scene_config(scene, library)
    geometry = pack_geometry(scene, library, device)
    params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
    camera, shadow = raster_setups(geometry, params, config)
    reports = [
        compare_raster("default_camera", camera, config.padded_width, config.padded_height, False),
        compare_raster("default_sun_shadow", shadow, config.shadow_dim, config.shadow_dim, True),
    ]

    dense, dense_lib = dense_sphere_field()
    look_at(dense, (18.0, -16.0, -22.0), (0.0, -6.0, 0.0))
    dconfig = default_scene_config(dense, dense_lib, width=960, height=544)
    dgeometry = pack_geometry(dense, dense_lib, device)
    check(int(dgeometry.tri_valid.sum()) == 253_952, "dense field is not 253,952 triangles")
    dparams = upload_frame_params(pack_frame_params(dense, 960 / 544), device)
    dcamera, dshadow = raster_setups(dgeometry, dparams, dconfig)
    reports += [
        compare_raster("dense_camera", dcamera, dconfig.padded_width, dconfig.padded_height, False),
        compare_raster("dense_sun_shadow", dshadow, dconfig.shadow_dim, dconfig.shadow_dim, True),
    ]
    for r in reports:
        print("compare " + json.dumps(r))
    return reports


def phase_frames(device, n_frames=8, warmup=2, dt_seconds=20.0):
    from syzygy_tpu_torch.kernels.raster import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import render_frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, library = default_scene()
    scene.tick(0.0)
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
        check(tuple(image.shape) == (config.height, config.width, 3), f"frame shape {tuple(image.shape)}")
        check(bool(torch.isfinite(image).all()), f"frame {frame} has non-finite values")
        check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, f"frame {frame} outside [0, 1]")
        check(counts[-1][0] >= 1 and counts[-1][1] >= 1, f"frame {frame} launched {counts[-1]}")
        print(
            f"frame {frame}: {times[-1]:.3f} ms, sun time {scene.sun_animation.time:.4f}, "
            f"launches camera={counts[-1][0]} shadow={counts[-1][1]}, mean {float(image.mean()):.5f}"
        )
        scene.tick(dt_seconds)
    launches = {"visibility": LAUNCHES.visibility, "depth": LAUNCHES.depth}
    peak = torch.cuda.max_memory_allocated(device)
    result = {
        "frames": n_frames,
        "median_ms_per_frame": statistics.median(times[warmup:]),
        "ms_per_frame": times,
        "launches": launches,
        "peak_mem_bytes": int(peak),
        "resolution": [config.width, config.height],
    }
    print("frames " + json.dumps(result))
    return result


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
    print("golden " + json.dumps(result))
    check(rmse_cpu <= 1e-3, f"card vs CPU RMSE {rmse_cpu}")
    check(rmse_golden < 5e-3, f"card vs golden RMSE {rmse_golden}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import syzygy_tpu_torch
        from syzygy_tpu_torch.kernels import raster
    except ImportError as e:
        print(f"FAIL: the syzygy_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1
    if not os.path.abspath(syzygy_tpu_torch.__file__).startswith(ROOT + os.sep):
        print("FAIL: syzygy_tpu_torch was imported from outside this checkout", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(nvidia_smi_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    try:
        t0 = time.perf_counter()
        raster.build_kernel()
        print(f"build: {time.perf_counter() - t0:.2f} s")
        for path in os.listdir(raster._BUILD_DIR):
            if path.endswith(".log"):
                with open(os.path.join(raster._BUILD_DIR, path)) as f:
                    print("ptxas: " + " | ".join(line.strip() for line in f if line.strip()))
        compare = phase_compare(device)
        frames = phase_frames(device)
        phase_golden(device)
    except (SmokeFailure, RuntimeError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    by_name = {r["name"]: r for r in compare}
    src = "syzygy_tpu_torch/csrc/raster.cu"
    kernels = [
        {
            "name": "raster_visibility", "route": "cuda", "source": src,
            "replaces": "syzygy_tpu/kernels/raster.py:1014",
            "launches": frames["launches"]["visibility"],
            "max_abs_err": max(by_name[n]["max_abs_err"] for n in ("default_camera", "dense_camera")),
            "ms": by_name["default_camera"]["ms"],
            "plain_ms": by_name["default_camera"]["plain_ms"],
        },
        {
            "name": "raster_depth", "route": "cuda", "source": src,
            "replaces": "syzygy_tpu/kernels/raster.py:1005",
            "launches": frames["launches"]["depth"],
            "max_abs_err": max(
                by_name[n]["max_abs_err"] for n in ("default_sun_shadow", "dense_sun_shadow")
            ),
            "ms": by_name["default_sun_shadow"]["ms"],
            "plain_ms": by_name["default_sun_shadow"]["plain_ms"],
        },
    ]
    if any(k["launches"] < 1 for k in kernels):
        print("FAIL: a kernel of the main path was never launched", file=sys.stderr)
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
