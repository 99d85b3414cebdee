"""Headless renderer: render a scene for a few frames.

Port of the ``syzygy_tpu/app/__main__.py`` batch loop: builds a builtin
scene (``--scene``) or loads a .glb/.gltf (``--gltf``), frames it with
the reference app's default showcase view (eye (18, -16, -22) looking at
(0, -6, 0)), ticks it (the sun advances unless the scene freezes it),
renders each frame through :func:`renderer.frame.render_frame` on the
device, quantizes to u8 there, and writes one PNG per frame. The device
is the card unless ``--device cpu`` asks for the CPU. ``--no-atmosphere``,
``--debug-lines``, ``--mipmaps``, ``--supersample`` and ``--oetf`` are the
reference app's options of the same names.

Usage:
    python -m syzygy_tpu_torch.app --scene flagship --frames 4 --out frames
    python -m syzygy_tpu_torch.app --frames 1 --width 256 --height 128 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from syzygy_tpu_torch.app.scenes import BUILTIN_SCENES

EYE = (18.0, -16.0, -22.0)
LOOK_AT = (0.0, -6.0, 0.0)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="syzygy_tpu_torch headless renderer")
    parser.add_argument("--scene", type=str, default="default", choices=BUILTIN_SCENES)
    parser.add_argument("--gltf", type=str, default=None, help="path to .glb/.gltf (replaces --scene)")
    parser.add_argument("--frames", type=int, default=1)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--out", type=str, default="frames")
    parser.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    parser.add_argument("--shadow-dim", type=int, default=1024)
    parser.add_argument("--skyview-scale", type=int, default=1, help="divide the 2048x1024 sky-view LUT")
    parser.add_argument("--dt", type=float, default=1.0 / 60.0, help="scene seconds per frame")
    parser.add_argument("--no-atmosphere", action="store_true")
    parser.add_argument("--debug-lines", action="store_true")
    parser.add_argument("--mipmaps", action="store_true",
                        help="trilinear mipmapped textures (beyond-parity; reference is single-mip)")
    parser.add_argument("--supersample", type=int, default=1, help="SSAA factor (render at NxN subsamples)")
    parser.add_argument("--oetf", type=str, default="srgb", choices=["srgb", "pure_gamma"])
    args = parser.parse_args(argv)

    import torch

    from syzygy_tpu_torch.device import as_device
    from syzygy_tpu_torch.math.geometry import eulers_from_forward
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame
    from syzygy_tpu_torch.runtime import fetch_frame_u8
    from syzygy_tpu_torch.scene.pack import (
        pack_frame_params,
        pack_geometry,
        scene_uses_metallic,
        upload_frame_params,
    )
    from syzygy_tpu_torch.utils.png import write_png

    device = as_device(args.device)
    if args.gltf:
        from syzygy_tpu_torch.assets.gltf import load_gltf_scene

        scene, library = load_gltf_scene(args.gltf)
    else:
        from syzygy_tpu_torch.app.scenes import builtin_scene

        scene, library = builtin_scene(args.scene)
    scene.camera.position = EYE
    forward = torch.tensor(LOOK_AT, device="cpu") - torch.tensor(EYE, device="cpu")
    scene.camera.euler_angles = tuple(float(x) for x in eulers_from_forward(forward))
    scene.render_atmosphere = not args.no_atmosphere  # the lighting pass then lights the sun too
    scene.tick(0.0)
    config = RenderConfig(
        width=args.width,
        height=args.height,
        shadow_dim=args.shadow_dim,
        skyview_width=2048 // args.skyview_scale,
        skyview_height=1024 // args.skyview_scale,
        render_atmosphere=not args.no_atmosphere,
        debug_lines=args.debug_lines,
        supersample=args.supersample,
        oetf=args.oetf,
    )
    # the bounce multiplies to exactly zero without metallic materials
    config = dataclasses.replace(
        config, metallic_reflection=scene_uses_metallic(scene, library)
    )
    geometry = pack_geometry(scene, library, device, mipmaps=args.mipmaps)
    os.makedirs(args.out, exist_ok=True)
    for frame in range(args.frames):
        start = time.perf_counter()
        params = upload_frame_params(
            pack_frame_params(scene, args.width / args.height, debug_lines=args.debug_lines), device
        )
        image = fetch_frame_u8(render_frame(geometry, params, config))
        elapsed = (time.perf_counter() - start) * 1000.0
        path = os.path.join(args.out, f"frame_{frame:04d}.png")
        write_png(path, image)
        print(f"frame {frame}: {elapsed:.1f} ms (host clock, incl. D2H) -> {path}")
        scene.tick(args.dt)
    if device.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB")


if __name__ == "__main__":
    main()
