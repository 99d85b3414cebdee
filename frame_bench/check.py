"""Whether the window's images are right: the plain reference renders the
same frames again, from the same inputs, and the images are compared.

The frames compared are those the window kept (a sample drawn from the
seed, :class:`harness._HostCopies`): the images as the port's frame entry
returned them and the harness copied them to host memory, at the timed
size. The reference (:mod:`frame_bench.reference`) builds its own scene
from the scene module's inputs through its own scene and glTF API, ticks
it to each kept frame with the same :class:`harness.Inputs`, packs its own
params and renders op by op. Each compared number is the worst over the
kept frames, held against the cell's limit (``checks/<workload>.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from frame_bench.harness import Inputs, reference_api, scene_module


def reference_frames(cell, seed: int, device, ks):
    """Yield (k, geometry, params, config) of the reference for each frame
    number in ``ks``, in ascending order."""
    api = reference_api()
    module = scene_module(cell.config)
    scene, library = module.build(api, module.inputs())
    inputs = Inputs(cell.config, cell.traffic, seed)
    inputs.start(scene)
    config = api.RenderConfig(**cell.config["render"])
    geometry = api.pack_geometry(scene, library, device)
    aspect = config.width / config.height
    k = 0
    for target in sorted(set(ks)):
        while k < target:
            k += 1
            inputs.step(scene, k)
        yield k, geometry, api.upload_frame_params(api.pack_frame_params(scene, aspect), device), config


def compare(image: np.ndarray, reference: np.ndarray) -> dict:
    """One frame's readings: the root mean square and the largest
    absolute difference over every pixel and channel (the cell's limits
    say which are held to a limit)."""
    if image.shape != reference.shape:
        return {"rmse": float("inf"), "max_abs": float("inf")}
    diff = image.astype(np.float64) - reference.astype(np.float64)
    return {"rmse": float(np.sqrt(np.mean(diff * diff))), "max_abs": float(np.max(np.abs(diff)))}


def judge(readings: dict, limits: dict, expected: int) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): each number's worst reading
    over the frames against its limit. Fewer frames than ``expected``, or
    a reading that is not finite, is not correct."""
    checks = {"frames": {"value": len(readings), "limit": expected}}
    ok = len(readings) >= expected
    for name, limit in limits.items():
        values = [r[name] for r in readings.values()]
        worst = max(values) if values else float("inf")
        if not np.isfinite(worst):
            worst = float("inf")
        checks[name] = {"value": worst, "limit": limit}
        ok = ok and worst <= limit
    return bool(ok), checks


def check_run(run, device, roofline_frames=()) -> tuple[bool, dict, dict, object]:
    """Render the run's kept frames (and ``roofline_frames``, whose raster
    work is counted) with the reference. Returns (correct, checks,
    per-frame readings, the summed raster work of ``roofline_frames``)."""
    from frame_bench.roofline import Work, raster_work

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    render = reference_api().render_frame
    readings, work = {}, Work()
    wanted = set(run.kept) | set(roofline_frames)
    for k, geometry, params, config in reference_frames(run.cell, run.seed, device, wanted):
        if k in roofline_frames:
            work = work + raster_work(geometry, params, config)
        if k in run.kept:
            reference = render(geometry, params, config).cpu().numpy()
            readings[k] = compare(run.kept[k], reference)
    expected = min(int(run.cell.traffic["check_frames"]), len(run.frames))
    correct, checks = judge(readings, run.cell.limits, expected)
    return correct, checks, readings, work

