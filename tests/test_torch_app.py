"""The app (``python -m syzygy_tpu_torch.app``) on the CPU, held against
its own direct renders and against the JAX package's app.

One batch run at 128x64 (shadow map 256^2, sky-view 64x32,
transmittance LUT 64x16) covers ``--orbit``, ``--input-script``,
``--set`` of a scene property and a config field, ``--save-scene``,
``--dump-gbuffer`` and ``--dump-texture all``. Tolerances: bitwise for the
frames (the last PNG against a direct ``render_frame_packed`` of the saved
scene; ``--load-scene`` of that file), the camera (the input script
replayed through the reference's ``Scene.handle_input``), the texture
dumps, the property and texture listings (text equal to the reference
app's, the compute-collection demos' PNGs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import syzygy_tpu_torch  # noqa: F401  (precision pins)

torch.set_num_threads(2)

SMALL = [
    "--device", "cpu", "--width", "128", "--height", "64", "--shadow-dim", "128", "--skyview-scale", "32",
    "--set", "config.transmittance_width=64", "--set", "config.transmittance_height=16",
]
INPUT_SCRIPT = [{"keys": "w"}, {"keys": "d"}, {"cursor": [12, -5]}]
FRAMES = 3


def _read(path):
    from syzygy_tpu_torch.utils.png import read_png

    return read_png(str(path))[..., :3]


def _direct_frame(scene, library, config):
    """``fetch_frame_u8(render_frame_packed(...))`` of a scene's state, as
    the app renders it."""
    from syzygy_tpu_torch.renderer.frame import render_frame_packed
    from syzygy_tpu_torch.runtime import fetch_frame_u8
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry

    params = pack_frame_params(scene, config.width / config.height)
    spec = frame_param_spec(params)
    geometry = pack_geometry(scene, library, "cpu")
    return fetch_frame_u8(render_frame_packed(geometry, flatten_frame_params(params, spec), spec, config))


def _ref_main(monkeypatch, argv):
    """The JAX package's app with ``argv``."""
    from syzygy_tpu.app.__main__ import main as ref_main

    monkeypatch.setattr(sys, "argv", ["syzygy_tpu.app", *argv])
    ref_main()


@pytest.fixture(scope="module")
def app_run(tmp_path_factory):
    from syzygy_tpu_torch.app.__main__ import main

    tmp = tmp_path_factory.mktemp("app")
    script = tmp / "input.json"
    script.write_text(json.dumps(INPUT_SCRIPT))
    out, saved = tmp / "frames", tmp / "scene.json"
    result = main(SMALL + [
        "--frames", str(FRAMES), "--orbit", "--input-script", str(script), "--time-of-day", "0.35",
        "--set", "camera.fov_degrees=60", "--set", "config.shadow_dim=256", "--save-scene", str(saved),
        "--dump-gbuffer", "--dump-texture", "all", "--out", str(out),
    ])
    return result, out, saved


def test_app_writes_every_frame(app_run):
    """One 128x64 PNG per frame, the orbit moves the camera, the FPS ring
    holds the steady frames (not the first), the config edit reached the
    renderer."""
    result, out, _ = app_run
    assert [os.path.basename(p) for p in result["paths"]] == [f"frame_{i:04d}.png" for i in range(FRAMES)]
    frames = [_read(p) for p in result["paths"]]
    assert all(f.shape == (64, 128, 3) for f in frames)
    assert not np.array_equal(frames[0], frames[-1])
    assert len(result["frame_ms"]) == FRAMES and result["fps"].endswith(f"| n {FRAMES - 1}")
    assert result["config"].shadow_dim == 256 and result["config"].transmittance_width == 64


def test_app_last_frame_is_the_saved_scene(app_run):
    """The last PNG is bitwise a direct ``render_frame_packed`` of the
    ``--save-scene`` file after ``load_scene``, at the app's config."""
    from syzygy_tpu_torch.scene.scene import default_scene
    from syzygy_tpu_torch.scene.serialize import load_scene, mesh_source_of

    result, _, saved = app_run
    own, library = default_scene()
    scene = load_scene(str(saved), mesh_source_of(own))
    assert scene.camera.fov_degrees == 60.0
    np.testing.assert_array_equal(_direct_frame(scene, library, result["config"]), _read(result["paths"][-1]))


def test_app_load_scene_renders_the_saved_frame(app_run, tmp_path):
    """``--load-scene`` (meshes ``mesh_Cube/Plane/Sphere``) of the saved
    file, framed from the last orbit position at the same target, renders
    the app's last frame again, bitwise."""
    from syzygy_tpu_torch.app.__main__ import LOOK_AT, main

    result, _, saved = app_run
    pos = json.loads(saved.read_text())["cameras"][0]["position"]
    again = main(SMALL + [
        "--load-scene", str(saved), "--set", "config.shadow_dim=256", "--out", str(tmp_path),
        "--camera-pos=" + ",".join(repr(float(np.float32(x))) for x in pos),
        "--camera-look=" + ",".join(repr(x) for x in LOOK_AT),
    ])
    np.testing.assert_array_equal(_read(again["paths"][0]), _read(result["paths"][-1]))


def test_app_dump_gbuffer(app_run):
    """``--dump-gbuffer`` writes the G-buffer planes and depth at the frame
    size, the shadow map at its dim, and both atmosphere LUTs at theirs."""
    _, out, _ = app_run
    sizes = {
        "gbuffer_diffuse": (64, 128), "gbuffer_specular": (64, 128), "gbuffer_normal": (64, 128),
        "gbuffer_worldpos": (64, 128), "gbuffer_orm": (64, 128), "depth": (64, 128),
        "shadow_map_0": (256, 256), "transmittance_lut": (16, 64), "skyview_lut": (32, 64),
    }
    for name, shape in sizes.items():
        img = _read(out / f"{name}.png")
        assert img.shape[:2] == shape, name
    assert _read(out / "gbuffer_diffuse.png").max() > 0 and len(np.unique(_read(out / "depth.png"))) > 2


def test_app_dump_texture_all_matches_reference(app_run):
    """``--dump-texture all`` writes every registered texture of the
    reference's default scene at native size: sRGB color maps encoded
    again, linear maps raw, bitwise the reference's texels."""
    from syzygy_tpu.assets.types import linear_to_srgb as ref_linear_to_srgb
    from syzygy_tpu.scene import default_scene as ref_default

    _, out, _ = app_run
    _, ref_lib = ref_default()
    for name in ref_lib.names():
        idx = ref_lib.lookup(name)
        tex = ref_lib.get(idx)[..., :3]
        if ref_lib.is_srgb(idx):
            tex = ref_linear_to_srgb(tex)
        want = (np.clip(tex, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(_read(out / f"texture_{name}.png"), want, err_msg=name)


def test_app_input_script_matches_reference(tmp_path):
    """``--input-script`` without ``--orbit``: after the frames the saved
    camera is bitwise where the reference's ``Scene.handle_input`` leaves
    it, replaying the same entries from the app's default framing."""
    from syzygy_tpu.math.geometry import eulers_from_forward as ref_eulers_from_forward
    from syzygy_tpu.scene import default_scene as ref_default

    from syzygy_tpu_torch.app.__main__ import EYE, LOOK_AT, main

    script = tmp_path / "input.json"
    script.write_text(json.dumps(INPUT_SCRIPT))
    saved = tmp_path / "scene.json"
    tiny = SMALL[:2] + ["--width", "32", "--height", "16"] + SMALL[6:]
    main(tiny + ["--frames", str(FRAMES), "--input-script", str(script), "--save-scene", str(saved),
                 "--out", str(tmp_path / "frames")])
    ref, _ = ref_default()
    eye, target = np.asarray(EYE, np.float32), np.asarray(LOOK_AT, np.float32)
    ref.camera.position = tuple(eye)
    ref.camera.euler_angles = tuple(np.asarray(ref_eulers_from_forward(target - eye)))
    for entry in INPUT_SCRIPT:
        ref.handle_input(1.0 / 60.0, tuple(entry.get("cursor", (0.0, 0.0))), frozenset(entry.get("keys", "")))
    camera = json.loads(saved.read_text())["cameras"][0]
    assert camera["position"] == [float(x) for x in ref.camera.position]
    assert camera["euler_angles"] == [float(x) for x in ref.camera.euler_angles]


@pytest.mark.parametrize("scene", ["default", "chessboard"])
def test_list_properties_matches_reference(scene, capsys, monkeypatch):
    """``--list-properties`` after the same ``--set`` edits (a reset among
    them) prints the reference app's table, character for character."""
    from syzygy_tpu_torch.app.__main__ import main

    argv = ["--scene", scene, "--set", "camera.fov_degrees=60", "--set", "camera_speed=7.5",
            "--set", "atmosphere.sun_euler_angles=[1.2,0,0.5]", "--set", "atmosphere.sun_euler_angles=default",
            "--list-properties"]
    main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out
    _ref_main(monkeypatch, argv)
    ref = capsys.readouterr().out
    assert port == ref and "cameras[0].fov_degrees" in port


@pytest.mark.parametrize("scene", ["default", "chessboard"])
def test_list_textures_matches_reference(scene, capsys, monkeypatch):
    """``--list-textures`` prints the reference app's listing: index, size
    and name of every registered texture."""
    from syzygy_tpu_torch.app.__main__ import main

    main(["--scene", scene, "--list-textures", "--device", "cpu"])
    port = capsys.readouterr().out
    _ref_main(monkeypatch, ["--scene", scene, "--list-textures"])
    assert port == capsys.readouterr().out and port.count("\n") >= 3


@pytest.mark.parametrize("shader", ["gradient", "matrix", "boolean", "sparse"])
def test_compute_collection_matches_reference(shader, tmp_path):
    """``--pipeline compute-collection``: each demo shader's PNG against
    the reference's ``_run_compute_collection`` on the same arguments."""
    from syzygy_tpu.app.__main__ import _run_compute_collection

    from syzygy_tpu_torch.app.__main__ import main

    assert main(["--pipeline", "compute-collection", "--compute-shader", shader, "--device", "cpu",
                 "--width", "64", "--height", "32", "--out", str(tmp_path / "port")]) is None
    ref_out = tmp_path / "ref"
    ref_out.mkdir()
    _run_compute_collection(argparse.Namespace(width=64, height=32, compute_shader=shader, oetf="srgb",
                                               out=str(ref_out)))
    port, ref = _read(tmp_path / "port" / "compute_0000.png"), _read(ref_out / "compute_0000.png")
    assert port.shape == (32, 64, 3)
    np.testing.assert_array_equal(port, ref)


def test_app_refuses_the_cpu_fallback(monkeypatch, tmp_path):
    """The default device is ``cuda``: without a card (and without
    ``--device cpu``) the app raises instead of rendering on the CPU."""
    from syzygy_tpu_torch.app.__main__ import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    assert "--cpu" not in build_parser().format_help()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--frames", "1", "--out", str(tmp_path)])
    assert not list(tmp_path.glob("*.png"))


def test_app_options_match_reference():
    """Every option of the reference app, under its name and default, but
    ``--cpu`` (``--device cpu`` here)."""
    import ast

    from syzygy_tpu_torch.app.__main__ import build_parser

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "syzygy_tpu", "app", "__main__.py")) as f:
        tree = ast.parse(f.read())
    ref = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {
                k.arg: eval(compile(ast.Expression(k.value), "<default>", "eval"))  # constants like 1.0 / 60.0
                for k in node.keywords
                if k.arg in ("default", "action")
            }
            ref[node.args[0].value] = kw.get("default", False if kw.get("action") == "store_true" else None)
    port = {a.option_strings[0]: a.default for a in build_parser()._actions if a.option_strings[0] != "-h"}
    assert set(ref) - {"--cpu"} == set(port) - {"--device"}
    assert {flag: port[flag] for flag in ref if flag != "--cpu"} == {f: d for f, d in ref.items() if f != "--cpu"}


def test_watch_renders_again_when_the_file_changes(tmp_path):
    """``--watch``: the app seeds the file with the scene, renders, then
    waits for the file to change and renders the edited scene."""
    from syzygy_tpu_torch.app.__main__ import main

    watched, out = tmp_path / "scene.json", tmp_path / "frames"
    tiny = SMALL[:2] + ["--width", "32", "--height", "16"] + SMALL[6:]
    result = {}
    thread = threading.Thread(
        target=lambda: result.update(main(tiny + ["--frames", "2", "--watch", str(watched), "--out", str(out)])),
        daemon=True,
    )
    thread.start()
    deadline = time.monotonic() + 120
    while not (out / "frame_0000.png").exists() and time.monotonic() < deadline:
        time.sleep(0.1)
    data = json.loads(watched.read_text())
    data["cameras"][0]["fov_degrees"] = 100.0
    watched.write_text(json.dumps(data))
    stat = os.stat(watched)
    os.utime(watched, ns=(stat.st_atime_ns, stat.st_mtime_ns + 10**9))
    thread.join(timeout=120)
    assert not thread.is_alive()
    first, second = (_read(p) for p in result["paths"])
    assert first.shape == second.shape == (16, 32, 3) and not np.array_equal(first, second)
