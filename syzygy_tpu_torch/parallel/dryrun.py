"""The port's multi-device dry run, and the rank functions behind it.

    python -m syzygy_tpu_torch.parallel.dryrun N [--device cpu|cuda]

Port of ``__graft_entry__.dryrun_multichip``: starts N ranks
(:func:`ranks.run`) once and renders, each over a (dp, sp) mesh: a dp=2 batch
(one frame per dp row) at 128 wide and one tile row per sp rank, the full
1920x1080 frame at sp=N (1088 padded rows do not divide by N, the pad-
and-crop path), and a dp=4 batch when 4 divides N. Each case checks the
shape and finite pixels and prints one line. The device defaults to the
card (``--device cuda``: one card per rank under NCCL, or several ranks on
a card under gloo); ``--device cpu`` runs gloo ranks on the host.

:func:`render_case`, :func:`render_cases` and :func:`partition_case` are
what each rank runs;
:func:`case_params` gives any process the frames a case renders.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from syzygy_tpu_torch.parallel import ranks

DRYRUN_EYE, DRYRUN_TARGET = (18.0, -16.0, -22.0), (0.0, -6.0, 0.0)  # __graft_entry__.py:14-15
FLAGSHIP_EYE, FLAGSHIP_TARGET = (13.0, -8.0, -14.0), (0.0, -1.0, 0.0)  # bench.py:264-271
SMALL = dict(shadow_dim=128, skyview_width=128, skyview_height=64)  # __graft_entry__.py:116-121
TIMEOUT = 1800.0  # s: the dry run's ranks, all cases together


def case_scene(scene: str = "default", atmosphere: bool = True):
    """The dry run's default scene (sun time 0.35, camera of
    ``__graft_entry__._flagship``) or the chess flagship framed as
    ``bench.py`` frames it, each ticked once by 0; ``atmosphere=False``
    renders a clear sky (the app's ``--no-atmosphere``)."""
    from syzygy_tpu_torch.math.geometry import eulers_from_forward
    from syzygy_tpu_torch.scene.scene import default_scene

    if scene == "default":
        scene_, library = default_scene()
        scene_.sun_animation.time = 0.35
        eye, target = DRYRUN_EYE, DRYRUN_TARGET
    elif scene == "flagship":
        from syzygy_tpu_torch.assets.chess import flagship_scene

        scene_, library = flagship_scene()
        eye, target = FLAGSHIP_EYE, FLAGSHIP_TARGET
    else:
        raise ValueError(f"unknown scene {scene!r}")
    scene_.render_atmosphere = atmosphere
    scene_.tick(0.0)
    scene_.camera.position = eye
    forward = torch.tensor(target, dtype=torch.float32) - torch.tensor(eye, dtype=torch.float32)
    scene_.camera.euler_angles = tuple(float(x) for x in eulers_from_forward(forward))
    return scene_, library


def case_params(scene: str, frames: int, dt: float, aspect: float, atmosphere: bool = True):
    """(scene, library, [FrameParams]): ``frames`` host frames, the scene
    ticked by ``dt`` before each."""
    from syzygy_tpu_torch.scene.pack import pack_frame_params

    scene_, library = case_scene(scene, atmosphere)
    params = []
    for _ in range(frames):
        scene_.tick(dt)
        params.append(pack_frame_params(scene_, aspect))
    return scene_, library, params


def render_case(dp: int, sp: int, width: int, height: int, frames: int, device: str,
                scene: str = "default", dt: float = 1.0 / 60.0, config: dict | None = None,
                atmosphere: bool = True, warm: bool = False) -> dict:
    """One rank's part of rendering ``frames`` frames over a (dp, sp) mesh
    (:func:`parallel.sharding.render_frames_sharded`) on ``device``
    (``cpu`` or ``cuda``). Returns the batch as every rank holds it (CPU),
    the host ms of the render (``ms``) and the raster launches this rank
    made in it. A fresh process's first render also loads the kernels and
    fills the allocator's pools: with ``warm`` it is rendered first, timed
    apart (``first_ms``) and held bitwise against the counted one, which
    is what a timing on the card needs; else ``first_ms`` is None."""
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.parallel.sharding import (
        batch_params,
        make_mesh,
        render_frames_sharded,
        replicate_to_mesh,
    )
    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.pack import pack_geometry

    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    mesh = make_mesh(dp, sp, dev)
    cfg = RenderConfig(width=width, height=height, **(config or {}))
    scene_, library, params = case_params(scene, frames, dt, width / height, atmosphere)
    geometry = replicate_to_mesh(pack_geometry(scene_, library, dev), mesh)
    batch = batch_params(params)

    def timed():
        dist.barrier()
        t0 = time.perf_counter()
        out = render_frames_sharded(geometry, batch, cfg, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    first, first_ms = timed() if warm else (None, None)
    before = LAUNCHES.copy()
    images, ms = timed()
    made = LAUNCHES - before
    if warm and not torch.equal(images, first):
        raise RuntimeError("render_frames_sharded gave two different batches for the same frames")
    return {
        "images": images.cpu(),
        "ms": ms,
        "first_ms": first_ms,
        "launches": {"visibility": made["visibility"], "depth": made["depth"]},
        "device": str(dev),
    }


def render_cases(cases: list[dict], device: str) -> list[dict]:
    """:func:`render_case` of each entry of ``cases`` (its keyword
    arguments but ``device``) in turn, in this one process: each case
    makes its own mesh over the same ranks, so one start of the ranks
    serves them all."""
    return [render_case(device=device, **case) for case in cases]


def partition_case(sp: int, maps: list, device: str, width: int = 256, height: int = 128,
                   shadow_dim: int = 128) -> dict:
    """The three split sites of one frame of the dry run's scene on a
    (1, sp) mesh on ``device``, each split and whole on this rank: the
    camera triangle setup and the resolve records, and the shadow rasters
    of the first ``max(maps) + 1`` map slots, those in ``maps`` active.
    Returns both versions of each (CPU)."""
    from syzygy_tpu_torch.kernels.raster import setup_triangles
    from syzygy_tpu_torch.kernels.resolve import build_resolve_records, transform_normals, transform_positions
    from syzygy_tpu_torch.math.geometry import matmul4
    from syzygy_tpu_torch.parallel.sharding import make_mesh
    from syzygy_tpu_torch.renderer.frame import RenderConfig, _shadow_pass
    from syzygy_tpu_torch.scene.pack import pack_geometry, prepare_frame_state, upload_frame_params

    mesh = make_mesh(1, sp, device)
    scene_, library, (params,) = case_params("default", 1, 0.0, width / height)
    geometry = pack_geometry(scene_, library, mesh.device)
    state = prepare_frame_state(upload_frame_params(params, mesh.device))
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, matmul4(state.camera.projection, state.camera.view)
    )
    normals = transform_normals(geometry.normals, geometry.vert_instance, state.model_inv_transpose)
    world_h = torch.cat([world, torch.ones_like(world[:, :1])], dim=-1)
    config = RenderConfig(width=width, height=height, shadow_dim=shadow_dim)
    active = torch.zeros(max(maps, default=-1) + 1, dtype=torch.bool)
    active[list(maps)] = True
    active = active.to(mesh.device)
    out = {}
    for name, group in (("split", mesh.sp_group), ("whole", None)):
        setup = setup_triangles(clip, geometry.triangles, geometry.tri_valid, width, height, +1, group=group)
        out[name] = {
            "setup": {k: v.cpu() for k, v in setup._asdict().items()},
            "records": build_resolve_records(setup, geometry, world, normals, group).cpu(),
            "shadow_maps": _shadow_pass(geometry, world_h, state, config, active, group).cpu(),
        }
    return out


def main(argv=None) -> None:
    from syzygy_tpu_torch.kernels.raster import TILE_H

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, help="number of ranks")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = parser.parse_args(argv)
    n = args.n
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda is unavailable (pass --device cpu)")
    meshes = [(2, n // 2, 128, None) if n % 2 == 0 else (1, n, 128, None), (1, n, 1920, 1080)]
    if n % 4 == 0:
        meshes.append((4, n // 4, 128, None))
    cases = [
        dict(dp=dp, sp=sp, width=width, height=TILE_H * sp if height is None else height, frames=dp, config=SMALL)
        for dp, sp, width, height in meshes
    ]
    threads = max(1, (os.cpu_count() or 1) // n) if args.device == "cpu" else 1
    per_rank = ranks.run(
        n, "syzygy_tpu_torch.parallel.dryrun:render_cases", dict(cases=cases, device=args.device),
        device=args.device, timeout=TIMEOUT, threads=threads,
    )
    for k, case in enumerate(cases):
        dp, sp, width, height = case["dp"], case["sp"], case["width"], case["height"]
        results = [r[k] for r in per_rank]
        images = results[0]["images"]
        if tuple(images.shape) != (dp, height, width, 3):
            raise RuntimeError(f"mesh ({dp}, {sp}): images {tuple(images.shape)}")
        if not bool(torch.isfinite(images).all()):
            raise RuntimeError(f"mesh ({dp}, {sp}): non-finite pixels")
        if not all(torch.equal(r["images"], images) for r in results):
            raise RuntimeError(f"mesh ({dp}, {sp}): the ranks returned different batches")
        print(
            f"dryrun OK: mesh (dp={dp}, sp={sp}) on {n} {args.device} ranks ({results[0]['device']}), "
            f"images {tuple(images.shape)}, mean {float(images.mean()):.4f}, "
            f"rank 0 {results[0]['ms']:.1f} ms",
            flush=True,
        )


if __name__ == "__main__":
    main()
