"""Headless app: the editor frame loop without a window.

Port of ``syzygy_tpu/app/__main__.py`` (``editor/editor.cpp:441-779``):
ticks the scene (sun animation, instance animations, scripted fly-camera
input, ``--orbit``), renders each frame through
:func:`renderer.frame.render_frame_packed` from one reused flat parameter
buffer, quantizes to u8 on the device, writes one PNG per frame and keeps
an FPS ring buffer. ``--serve`` starts the interactive browser viewer
(:mod:`app.serve`) instead. Every option of the reference app has the same
name and default here, but ``--cpu``: the device is ``--device`` (``cuda``
by default; ``cpu`` asks for the CPU). Without a card and without
``--device cpu`` the app raises.

Pipelines (``Renderer::RenderingPipelines``, ``renderer.cpp:381-443``):
  deferred            the full G-buffer + lighting + atmosphere frame
  compute-collection  the demo fullscreen compute shaders

Usage:
    python -m syzygy_tpu_torch.app --scene flagship --frames 4 --orbit --out frames
    python -m syzygy_tpu_torch.app --scene flagship --serve
    python -m syzygy_tpu_torch.app --frames 1 --width 256 --height 128 --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time

from syzygy_tpu_torch.app.scenes import BUILTIN_SCENES

log = logging.getLogger("syzygy")

# the default framing: the showcase view (the scene's own default camera
# starts 2 units from a cube face, which suits the reference's fly-camera
# editor, not a headless frame)
EYE = (18.0, -16.0, -22.0)
LOOK_AT = (0.0, -6.0, 0.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="syzygy_tpu_torch headless renderer")
    parser.add_argument("--frames", type=int, default=1)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--out", type=str, default="frames")
    parser.add_argument("--pipeline", type=str, default="deferred", choices=["deferred", "compute-collection"])
    parser.add_argument("--compute-shader", type=str, default="gradient",
                        choices=["gradient", "matrix", "boolean", "sparse"])
    parser.add_argument("--scene", type=str, default="default", choices=BUILTIN_SCENES)
    parser.add_argument("--gltf", type=str, default=None, help="path to .glb/.gltf (replaces --scene)")
    parser.add_argument("--load-scene", type=str, default=None,
                        help="scene JSON of --save-scene (meshes mesh_Cube/Plane/Sphere)")
    parser.add_argument("--save-scene", type=str, default=None, help="write the final scene state as JSON")
    parser.add_argument("--no-atmosphere", action="store_true")
    parser.add_argument("--debug-lines", action="store_true")
    parser.add_argument("--dump-gbuffer", action="store_true",
                        help="also write G-buffer planes, depth, shadow map and atmosphere LUTs as PNGs")
    parser.add_argument("--dump-texture", action="append", default=[],
                        help="write a registered texture to PNG by name ('all' dumps every one); repeatable")
    parser.add_argument("--list-textures", action="store_true", help="print every registered texture and exit")
    parser.add_argument("--fps-target", type=float, default=0.0,
                        help="pace the loop to this FPS (editor.cpp:605-608); 0 = flat out")
    parser.add_argument("--shadow-dim", type=int, default=1024)
    parser.add_argument("--skyview-scale", type=int, default=1, help="divide the 2048x1024 sky-view LUT")
    parser.add_argument("--supersample", type=int, default=1, help="SSAA factor (render at NxN subsamples)")
    parser.add_argument("--oetf", type=str, default="srgb", choices=["srgb", "pure_gamma"])
    parser.add_argument("--dt", type=float, default=1.0 / 60.0, help="scene seconds per frame")
    parser.add_argument("--time-of-day", type=float, default=None, help="sun time in [0,1); 0.5 = noon")
    parser.add_argument("--sun-speed", type=float, default=100.0)
    parser.add_argument("--camera-index", type=int, default=0, help="active camera (scenes may hold up to 20)")
    parser.add_argument("--camera-pos", type=str, default=None, help="x,y,z")
    parser.add_argument("--camera-look", type=str, default=None, help="x,y,z")
    parser.add_argument("--orbit", action="store_true", help="orbit the camera around the look target")
    parser.add_argument("--input-script", type=str, default=None,
                        help="JSON list of per-frame {keys: 'wasdqe', cursor: [dx, dy]} entries "
                        "replayed through the fly-camera input handler")
    parser.add_argument("--watch", type=str, default=None,
                        help="seed this JSON with the scene, then re-render whenever the file changes")
    parser.add_argument("--list-properties", action="store_true",
                        help="print the property table (name / value / reset default) and exit")
    parser.add_argument("--set", action="append", default=[], metavar="PATH=VALUE",
                        help="set a scene property by dotted path (camera.fov_degrees=90) or a "
                        "RenderConfig field (config.shadow_dim=2048); VALUE 'default' resets; repeatable")
    parser.add_argument("--mipmaps", action="store_true",
                        help="trilinear mipmapped textures (beyond-parity; reference is single-mip)")
    parser.add_argument("--serve", action="store_true",
                        help="interactive browser viewer: WASDQE + drag fly camera and the live "
                        "property table over localhost HTTP")
    parser.add_argument("--port", type=int, default=8731, help="--serve port (default 8731)")
    parser.add_argument("--serve-frames", type=int, default=0,
                        help="stop --serve after N rendered frames (0 = run until interrupted)")
    parser.add_argument("--preview-scale", type=int, default=2,
                        help="--serve: 1/N-resolution frames while input is live, exact full "
                        "resolution at rest (1 disables)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    return parser


def _vec3(text: str):
    import numpy as np

    return np.asarray([float(v) for v in text.split(",")], np.float32)


def _look(scene, eye, target) -> None:
    """Point the active camera from ``eye`` at ``target`` (f32 arrays); the
    camera holds numpy f32 scalars, as the reference app's does."""
    import torch

    from syzygy_tpu_torch.math.geometry import eulers_from_forward

    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(eulers_from_forward(torch.from_numpy(target - eye)).numpy())


def main(argv=None):
    """Run the app; returns the deferred loop's summary (per-frame host ms,
    the FPS report, the PNG paths), or None for the modes that render no
    frame loop."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    import numpy as np

    from syzygy_tpu_torch.device import as_device
    from syzygy_tpu_torch.utils.png import write_png

    device = as_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.pipeline == "compute-collection":
        _run_compute_collection(args, device)
        return None

    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame_packed
    from syzygy_tpu_torch.runtime import fetch_frame_u8
    from syzygy_tpu_torch.scene.pack import (
        flatten_frame_params,
        frame_param_spec,
        pack_frame_params,
        pack_geometry,
        pack_geometry_host,
        scene_uses_metallic,
    )
    from syzygy_tpu_torch.utils.metrics import RingBuffer

    scene, library = _build_scene(args)
    if args.list_textures:
        for name in library.names():
            idx = library.lookup(name)
            h, w = library.get(idx).shape[:2]
            print(f"{idx:3d}  {w}x{h}  {name}")
        return None
    if args.dump_texture:
        _dump_textures(args, library)
    if args.time_of_day is not None:
        scene.sun_animation.time = args.time_of_day
        scene.sun_animation.frozen = True
    scene.sun_animation.speed = args.sun_speed
    scene.render_atmosphere = not args.no_atmosphere
    if args.camera_index:
        scene.camera_index = args.camera_index

    look_target = _vec3(args.camera_look) if args.camera_look else np.asarray(LOOK_AT, np.float32)
    eye = _vec3(args.camera_pos) if args.camera_pos else np.asarray(EYE, np.float32)
    _look(scene, eye, look_target)
    config_sets = [s for s in args.set if s.startswith("config.")]
    scene_sets = [s for s in args.set if not s.startswith("config.")]
    if scene_sets or args.list_properties:
        from syzygy_tpu_torch.app.properties import apply_set, discover, format_table

        for spec in scene_sets:
            log.info("set %s", apply_set(scene, spec))
        if args.list_properties:
            print(format_table(discover(scene)))
            return None
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
        # the bounce multiplies to exactly zero without metallic materials
        metallic_reflection=scene_uses_metallic(scene, library),
    )
    if config_sets:
        from syzygy_tpu_torch.app.properties import apply_config_field

        for spec in config_sets:
            path, _, text = spec.partition("=")
            config = apply_config_field(config, path[len("config."):].strip(), text.strip())
            log.info("set %s", path)
    config.check()
    if args.serve:
        from syzygy_tpu_torch.app.serve import serve

        serve(
            scene, library, config, port=args.port, mipmaps=args.mipmaps,
            frames=args.serve_frames, preview_scale=args.preview_scale, device=device,
        )
        return None

    geometry_host = pack_geometry_host(scene, library, mipmaps=args.mipmaps)
    geometry = pack_geometry(scene, library, device, mipmaps=args.mipmaps)
    aspect = args.width / args.height
    params = pack_frame_params(scene, aspect, debug_lines=args.debug_lines)
    spec = frame_param_spec(params)
    flat_buf = np.empty(spec.total, np.float32)

    input_script = None
    if args.input_script:
        with open(args.input_script) as f:
            input_script = json.load(f)
    if args.orbit:
        eye0 = np.asarray(scene.camera.position, np.float32)
        orbit_radius = float(np.linalg.norm((eye0 - look_target)[[0, 2]]))
        orbit_height = float(eye0[1])
        orbit_phase = math.atan2(eye0[2] - look_target[2], eye0[0] - look_target[0])

    log.info("rendering %d frame(s) at %dx%d on %s", args.frames, args.width, args.height, device)
    if args.watch:
        from syzygy_tpu_torch.scene.serialize import load_scene, mesh_source_of, save_scene

        if not os.path.exists(args.watch):
            save_scene(args.watch, scene)
            log.info("seeded %s; edit it to re-render", args.watch)
        watch_mtime = os.stat(args.watch).st_mtime
        watched = scene  # reloads take their meshes from the first scene

    fps_history = RingBuffer()
    frame_ms, paths = [], []
    t_total = next_frame_t = time.perf_counter()
    for frame_idx in range(args.frames):
        if args.fps_target > 0.0:
            # frame pacing against 1/fpsTarget (editor.cpp:605-608)
            while time.perf_counter() < next_frame_t:
                time.sleep(0.0005)
            next_frame_t = max(next_frame_t + 1.0 / args.fps_target, time.perf_counter() - 1.0)
        t0 = time.perf_counter()
        if args.watch and frame_idx > 0:
            # block until the watched file changes, then reload every property
            while os.stat(args.watch).st_mtime == watch_mtime:
                time.sleep(0.25)
            watch_mtime = os.stat(args.watch).st_mtime
            try:
                reloaded = load_scene(args.watch, mesh_source_of(watched))
            except (OSError, ValueError, KeyError, TypeError) as e:
                log.error("reload failed (%s); keeping the previous scene", e)
            else:
                scene = reloaded
                geometry_host = pack_geometry_host(scene, library, mipmaps=args.mipmaps)
                geometry = pack_geometry(scene, library, device, mipmaps=args.mipmaps)
                spec = frame_param_spec(pack_frame_params(scene, aspect, debug_lines=args.debug_lines))
                flat_buf = np.empty(spec.total, np.float32)
                log.info("reloaded %s", args.watch)
        if input_script:
            entry = input_script[frame_idx % len(input_script)]
            scene.handle_input(
                args.dt, cursor_delta=tuple(entry.get("cursor", (0.0, 0.0))), keys=frozenset(entry.get("keys", ""))
            )
        if args.orbit:
            angle = orbit_phase + frame_idx * 2.0 * math.pi / max(args.frames, 1)
            eye = look_target + np.array(
                [
                    orbit_radius * math.cos(angle),
                    orbit_height - look_target[1],
                    orbit_radius * math.sin(angle),
                ],
                np.float32,
            )
            _look(scene, eye, look_target)
        params = pack_frame_params(scene, aspect, debug_lines=args.debug_lines)
        flat = flatten_frame_params(params, spec, flat_buf)
        image = fetch_frame_u8(render_frame_packed(geometry, flat, spec, config))
        dt = time.perf_counter() - t0
        frame_ms.append(dt * 1e3)
        if frame_idx == 0:
            log.info("first frame (incl. kernel build and load): %.1f ms", dt * 1e3)
            # the Draw Results table (ui/engineui.cpp:111-126)
            from syzygy_tpu_torch.renderer.stats import frame_draw_stats

            for name, stat in frame_draw_stats(params, geometry_host, config).items():
                log.info("draw results [%s]: %s", name, stat)
        else:
            fps_history.write(1.0 / max(dt, 1e-9))
        paths.append(os.path.join(args.out, f"frame_{frame_idx:04d}.png"))
        write_png(paths[-1], image)
        scene.tick(args.dt)

    log.info("wrote %d frames to %s", args.frames, args.out)
    if args.frames > 1:
        log.info("fps (steady, host clock incl. D2H + png): %s", fps_history.report())
    log.info("total %.1f s", time.perf_counter() - t_total)
    if args.save_scene:
        from syzygy_tpu_torch.scene.serialize import save_scene

        save_scene(args.save_scene, scene)
        log.info("saved scene to %s", args.save_scene)
    if args.dump_gbuffer:
        _dump_gbuffer(args, geometry, params, config, device)
    return {"frame_ms": frame_ms, "fps": fps_history.report(), "paths": paths, "config": config}


def _dump_textures(args, library) -> None:
    """Registered textures at native resolution (TextureDisplay,
    ``ui/texturedisplay.cpp``): sRGB color maps are encoded again for
    display, linear maps are written raw."""
    from syzygy_tpu_torch.assets.types import linear_to_srgb
    from syzygy_tpu_torch.utils.png import write_png

    wanted = library.names() if "all" in args.dump_texture else args.dump_texture
    for name in wanted:
        idx = library.lookup(name)
        if idx is None:
            log.error("no texture named %r (see --list-textures)", name)
            continue
        tex = library.get(idx)[..., :3]
        if library.is_srgb(idx):
            tex = linear_to_srgb(tex)
        write_png(os.path.join(args.out, f"texture_{name.replace('/', '_')}.png"), tex)
        log.info("dumped texture %s", name)


def _dump_gbuffer(args, geometry, params, config, device) -> None:
    """TextureDisplay analog (``ui/texturedisplay.*``): the intermediate
    targets of the last frame as PNGs."""
    import torch

    from syzygy_tpu_torch.device import to_tensor
    from syzygy_tpu_torch.kernels.atmosphere import (
        METERS_PER_MM,
        compute_skyview_lut,
        compute_transmittance_lut,
    )
    from syzygy_tpu_torch.renderer.frame import _stage_geometry
    from syzygy_tpu_torch.scene.pack import upload_frame_params
    from syzygy_tpu_torch.utils.png import write_png

    state, vis, gbuffer, shadow_maps = _stage_geometry(geometry, upload_frame_params(params, device), config)

    def host(x):
        return x.float().cpu().numpy()

    def norm01(x):
        x = host(x)
        lo, hi = x.min(), x.max()
        return (x - lo) / max(hi - lo, 1e-9)

    h, w, out = config.height, config.width, args.out
    write_png(f"{out}/gbuffer_diffuse.png", host(gbuffer.diffuse[:h, :w, :3]))
    write_png(f"{out}/gbuffer_specular.png", host(gbuffer.specular[:h, :w, :3]))
    write_png(f"{out}/gbuffer_normal.png", host(gbuffer.normal[:h, :w, :3]) * 0.5 + 0.5)
    write_png(f"{out}/gbuffer_worldpos.png", norm01(gbuffer.world_position[:h, :w, :3]))
    write_png(f"{out}/gbuffer_orm.png", host(gbuffer.orm[:h, :w, :3]))
    write_png(f"{out}/depth.png", norm01(vis.depth[:h, :w])[..., None].repeat(3, -1))
    write_png(f"{out}/shadow_map_0.png", norm01(shadow_maps[0])[..., None].repeat(3, -1))
    atmo = state.atmosphere
    t_lut = compute_transmittance_lut(atmo, config.transmittance_width, config.transmittance_height)
    write_png(f"{out}/transmittance_lut.png", host(t_lut))
    origin = state.camera.position[:3] / METERS_PER_MM * to_tensor([1.0, -1.0, 1.0], device) + torch.stack(
        [torch.zeros_like(atmo.planet_radius_mm), atmo.planet_radius_mm, torch.zeros_like(atmo.planet_radius_mm)]
    )
    sky = compute_skyview_lut(atmo, origin, t_lut, config.skyview_width, config.skyview_height)
    write_png(f"{out}/skyview_lut.png", norm01(sky))
    log.info("dumped G-buffer/LUT textures to %s", out)


def _run_compute_collection(args, device) -> None:
    """Config-ladder entry 1: a fullscreen demo compute pass + the OETF
    (``ComputeCollectionPipeline``, ``renderer/pipelines.cpp:223-380``)."""
    import numpy as np

    from syzygy_tpu_torch.kernels.transfer import (
        boolean_push,
        gradient_color,
        matrix_color,
        oetf_pure_gamma,
        oetf_srgb,
        sparse_push,
    )
    from syzygy_tpu_torch.utils.png import write_png

    w, h = args.width, args.height
    if args.compute_shader == "gradient":
        img = gradient_color(w, h, device)
    elif args.compute_shader == "boolean":
        img = boolean_push(w, h, device, np.random.default_rng(1).integers(0, 2, (4, 4)))
    elif args.compute_shader == "sparse":
        img = sparse_push(w, h, device, (1.0, 0.3, 0.05, 1.0), (0.05, 0.1, 0.6, 1.0))
    else:
        rng = np.random.default_rng(0)
        img = matrix_color(w, h, device, *[rng.uniform(0, 1, (4, 4)).astype(np.float32) for _ in range(3)])
    rgb = img[..., :3]
    image = (oetf_srgb(rgb) if args.oetf == "srgb" else oetf_pure_gamma(rgb)).cpu().numpy()
    path = os.path.join(args.out, "compute_0000.png")
    write_png(path, image)
    log.info("compute-collection (%s): wrote %s", args.compute_shader, path)


def default_mesh_source(library):
    """The meshes a ``--load-scene`` file may name, on ``library``'s
    default material: ``mesh_Cube``, ``mesh_Plane``, ``mesh_Sphere``."""
    from syzygy_tpu_torch.assets.defaults import cube_mesh, plane_mesh, register_default_textures, sphere_mesh

    material = register_default_textures(library)
    return {
        "mesh_Cube": cube_mesh(material),
        "mesh_Plane": plane_mesh(material),
        "mesh_Sphere": sphere_mesh(material),
    }


def _build_scene(args):
    if args.load_scene:
        from syzygy_tpu_torch.assets.types import TextureLibrary
        from syzygy_tpu_torch.scene.serialize import load_scene

        library = TextureLibrary()
        return load_scene(args.load_scene, default_mesh_source(library).__getitem__), library
    if args.gltf:
        from syzygy_tpu_torch.assets.gltf import load_gltf_scene

        return load_gltf_scene(args.gltf)
    from syzygy_tpu_torch.app.scenes import builtin_scene

    return builtin_scene(args.scene)


if __name__ == "__main__":
    main()
