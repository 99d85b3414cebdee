"""Where a frame's time goes, on one GPU.

    python -m syzygy_tpu_torch.profile --scene default|dense|flagship|flagship-exact

Renders the scene at the default 1920x1080 RenderConfig on ``cuda:0``
(``flagship-exact``: the chess flagship in the quirk-exact configuration,
``n_shadow_maps=4, aerial_lut=False, fast_sky_reflection=False``):
2 warm-up frames (the first captures the frame's CUDA graph), then

1. median ms/frame of 5 frames through ``render_frame`` (replayed from
   the graph; CUDA events) and peak memory, and of 5 eager frames
   (``render_frame_eager``);
2. one replayed frame under ``torch.profiler`` with only CUDA activity
   on: the device's summed kernel (and copy) time, the number of
   launches, the span from the first kernel's start to the last one's
   end, and the busy share of that span; the summed kernel time is also
   divided by the replayed median ms/frame of step 1 (same run);
3. per layer, on eager frames: wall-clock ms of each frame-graph step. Each wrapped step
   synchronises before and after, so steps do not overlap and their sum
   exceeds an unwrapped frame by the added syncs. A step called inside
   another wrapped step counts only in the outer one: ``_shadow_pass``
   holds the shadow setups and depth rasters, and ``setup_triangles`` and
   ``rasterize`` hold only the camera's.

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import subprocess
import time

import torch

WIDTH, HEIGHT = 1920, 1080
TIMED_FRAMES = 5

# frame-graph steps, as render_frame_linear calls them
STEPS = (
    "prepare_frame_state", "transform_positions", "transform_normals", "light_activity",
    "_shadow_pass", "setup_triangles", "rasterize", "resolve_gbuffer",
    "deferred_lighting", "compute_transmittance_lut",
    "compute_skyview_lut", "compute_skyview_tseg", "pack_lut_q8", "build_aerial_lut",
    "sky_camera_pass", "draw_lines", "oetf_srgb",
)
# the quirk-exact configuration (tools/parity_1080p.py:51-57)
EXACT = dict(n_shadow_maps=4, aerial_lut=False, fast_sky_reflection=False)


def _scene(name: str, device):
    from syzygy_tpu_torch.bench import chess_scene, dense_scene
    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.pack import pack_geometry, scene_uses_metallic
    from syzygy_tpu_torch.scene.scene import default_scene

    if name == "default":
        scene, library = default_scene()
        scene.tick(0.0)
        scene.sun_animation.time = 0.35  # daylight: sun, moon and spot all light the frame
        scene.tick(0.0)
    elif name == "dense":
        scene, library = dense_scene()
    else:  # the chess flagship, framed as bench.py:260-271 frames it
        scene, library = chess_scene()
    config = dataclasses.replace(
        RenderConfig(width=WIDTH, height=HEIGHT, **(EXACT if name == "flagship-exact" else {})),
        metallic_reflection=scene_uses_metallic(scene, library),
    )
    return scene, pack_geometry(scene, library, device), config


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="per-layer frame profile")
    parser.add_argument("--scene", choices=["default", "dense", "flagship", "flagship-exact"], default="default")
    args = parser.parse_args(argv)

    from syzygy_tpu_torch.renderer import frame
    from syzygy_tpu_torch.scene.pack import pack_frame_params, upload_frame_params

    if not torch.cuda.is_available():
        raise SystemExit("the profile measures device time: it needs a CUDA GPU")
    device = torch.device("cuda", 0)
    scene, geometry, config = _scene(args.scene, device)

    def one_frame(render=frame.render_frame):
        params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
        return render(geometry, params, config)

    def timed_frames(render):
        times = []
        for _ in range(TIMED_FRAMES):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            one_frame(render)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return times

    for _ in range(2):
        one_frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    times = timed_frames(frame.render_frame)
    peak = int(torch.cuda.max_memory_allocated(device))
    eager_times = timed_frames(frame.render_frame_eager)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_frame()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1000.0
    span_ms = (
        max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    ) / 1000.0
    top = collections.Counter()
    for e in kernels:
        top[e.name[:60]] += e.time_range.elapsed_us() / 1000.0

    steps = collections.defaultdict(float)
    depth = [0]  # nesting level of the wrapped steps
    originals = {}
    for name in STEPS:
        orig = getattr(frame, name)
        originals[name] = orig

        def timed(*a, _orig=orig, _name=name, **k):
            if depth[0]:
                return _orig(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = _orig(*a, **k)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            steps[_name] += (time.perf_counter() - t0) * 1000.0
            return out

        setattr(frame, name, timed)
    try:
        one_frame(frame.render_frame_eager)
        steps.clear()
        one_frame(frame.render_frame_eager)
    finally:
        for name, orig in originals.items():
            setattr(frame, name, orig)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "nvidia_smi": smi[0] if smi else "not read",
        "scene": args.scene,
        "resolution": [config.width, config.height],
        "triangles": int(geometry.tri_valid.sum()),
        "median_ms_per_frame": statistics.median(times),
        "ms_per_frame": times,
        "eager_median_ms_per_frame": statistics.median(eager_times),
        "eager_ms_per_frame": eager_times,
        "peak_mem_bytes": peak,
        "profiled_frame": {
            "kernel_ms": busy_ms,
            "kernel_launches": len(kernels),
            "kernel_span_ms": span_ms,
            "busy_share_of_span": busy_ms / span_ms,
            "kernel_ms_over_median_frame": busy_ms / statistics.median(times),
            "top_kernels_ms": dict(top.most_common(12)),
        },
        "steps_ms_synced": dict(steps),
    }))


if __name__ == "__main__":
    main()
