"""The interactive viewer (``app/serve.py``) on the CPU: the reference's
``_State`` tests (``tests/test_properties.py:129-589``) on the port, its
routes against the JAX package's viewer on the same scene, and the two
faults of the reference's HTTP layer that the port does not inherit (a
portless IPv6 ``Host`` refused; refused edits and loads answered 200).

Frames are 64x32 (preview tests 128x64) with a 128^2 shadow map, a
64x16 sky-view and a 64x16 transmittance LUT. Comparisons are exact:
PNG bytes of one encoder, decoded pixels, JSON.
"""

from __future__ import annotations

import io
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import syzygy_tpu_torch  # noqa: F401  (precision pins)
from test_torch_common import TPU_ONLY_FIELDS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=64, height=32, shadow_dim=128, skyview_width=64, skyview_height=16,
             transmittance_width=64, transmittance_height=16)
# no proxy from the environment: every request stays on this host
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _ported_rows(rows):
    """The reference viewer's property rows less the ``config.*`` rows of
    its TPU-only fields, which the port does not have."""
    tpu_only = {f"config.{name}" for name in TPU_ONLY_FIELDS}
    return [row for row in rows if row["path"] not in tpu_only]


def _config(**overrides):
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    return RenderConfig(**(SMALL | overrides))


def _state(config=None, **kw):
    from syzygy_tpu_torch.app.serve import _State
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, library = default_scene()
    return _State(scene, library, config or _config(), device="cpu", **kw)


def _dims(png):
    from syzygy_tpu_torch.utils.png import decode_png

    h, w = decode_png(png).shape[:2]
    return w, h


def _write_png(path, rgba):
    from syzygy_tpu_torch.utils.png import write_png

    write_png(str(path), rgba)


def test_state_round_trip():
    """render -> cached re-render -> fly input invalidates -> a property
    edit (and its reset) renders another frame."""
    from syzygy_tpu_torch.app.properties import get_path

    state = _state()
    png1 = state.render_png()
    assert png1[:4] == b"\x89PNG" and _dims(png1) == (64, 32)
    assert state.render_png() is png1
    state.handle_input("w", (0.0, 0.0), 0.25)
    png2 = state.render_png()
    assert png2 != png1
    assert state.set_property("camera.fov_degrees", "110") == 110.0
    assert state.render_png() != png2
    state.set_property("camera.fov_degrees", "default")
    assert get_path(state.scene, "camera.fov_degrees") == 70.0
    assert all(isinstance(p["value"], str) for p in state.properties())


def test_state_stats():
    """/api/stats: frame ms, the FPS ring (the first frame is no sample),
    Draw Results, frames dispatched."""
    state = _state()
    state.render_png()
    s = state.stats()
    assert s["last_ms"] > 0.0 and s["fps"] == "no samples" and s["dispatched"] == 1
    assert any("draw calls" in v for v in s["draw_results"].values())
    state.handle_input("w", (0.0, 0.0), 0.1)
    state.render_png()
    assert "avg" in state.stats()["fps"] and state.stats()["dispatched"] == 2


def test_routes_match_the_reference_viewer():
    """The property rows (scene and ``config.*``; of the config, the
    fields the port has), the texture list and the Draw Results of the
    port's viewer equal the JAX package's viewer's on the same scene and
    config."""
    from syzygy_tpu.app.serve import _State as RefState
    from syzygy_tpu.renderer import RenderConfig as RefConfig
    from syzygy_tpu.scene import default_scene as ref_default

    ref_scene, ref_library = ref_default()
    ref = RefState(ref_scene, ref_library, RefConfig(**SMALL))
    port = _state()
    assert port.properties() == _ported_rows(ref.properties())
    assert port.textures() == ref.textures()
    assert port.stats()["draw_results"] == ref.stats()["draw_results"]
    port.handle_input("wd", (12.0, -5.0), 0.2)
    ref.handle_input("wd", (12.0, -5.0), 0.2)
    assert port.set_property("config.shadow_dim", "256") == ref.set_property("config.shadow_dim", "256") == 256
    assert port.set_property("spotlights[0].strength", "250") == ref.set_property("spotlights[0].strength", "250")
    assert port.properties() == _ported_rows(ref.properties())


def test_texture_inspector_and_srgb_roundtrip():
    """/api/textures lists every texture at its native size, /texture.png
    serves it; sRGB color maps are encoded again for display (source
    brightness), linear maps served raw; unknown names raise KeyError."""
    from syzygy_tpu_torch.app.serve import _State
    from syzygy_tpu_torch.scene.scene import default_scene
    from syzygy_tpu_torch.utils.png import decode_png

    scene, library = default_scene()
    src = np.zeros((2, 2, 4), np.uint8)
    src[..., :3] = 100
    src[..., 3] = 255
    library.register("color_map", src, srgb=True)
    library.register("linear_map", src, srgb=False)
    state = _State(scene, library, _config(), device="cpu")
    texs = state.textures()
    assert texs and all(t["w"] > 0 and t["h"] > 0 for t in texs)
    assert _dims(state.texture_png(texs[0]["name"])) == (texs[0]["w"], texs[0]["h"])
    assert abs(int(decode_png(state.texture_png("color_map"))[0, 0, 0]) - 100) <= 1
    assert int(decode_png(state.texture_png("linear_map"))[0, 0, 0]) == 100
    with pytest.raises(KeyError):
        state.texture_png("no-such-texture")


def test_concurrent_requests_lose_no_update():
    """The request threads share one ``_State`` and one frame counter.
    More threads than cores send fly input (a few also fetch frames) with
    a shortened switch interval: the camera and the clock end where the
    same steps taken one after another leave them, and the counter counts
    every frame it was told of, reaching its limit once."""
    import sys

    from syzygy_tpu_torch.app.serve import _Counter
    from syzygy_tpu_torch.scene.scene import default_scene

    n_threads, steps, dt = 2 * (os.cpu_count() or 4), 20, 0.05
    state = _state(_config(width=32, height=16))
    counter = _Counter(n_threads * steps)
    errors = []

    def client(i):
        try:
            for _ in range(steps):
                state.handle_input("w", (0.0, 0.0), dt)
                counter.add()
            if i % 8 == 0:
                assert state.render_png()[:4] == b"\x89PNG"
        except Exception as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    serial, _ = default_scene()
    for _ in range(n_threads * steps):
        serial.handle_input(dt, (0.0, 0.0), frozenset("w"))
        serial.tick(dt)
    assert state.scene.camera.position == serial.camera.position
    assert state.scene.time_elapsed == serial.time_elapsed
    assert counter.count == n_threads * steps and counter.done.is_set()


def test_pipeline_double_buffer():
    """Two frames in flight: a dirty request answers with the previous
    frame and leaves the new one in flight; the next one fetches it, and
    it is the frame a synchronous viewer renders."""
    state = _state(pipeline=True)
    png1 = state.render_png()
    assert not state.stats()["pending"]
    state.handle_input("w", (0.0, 0.0), 0.25)
    assert state.render_png() is png1
    assert state.stats()["pending"]
    png2 = state.render_png()
    assert png2 != png1 and not state.stats()["pending"]
    assert state.render_png() is png2
    ref = _state()
    ref.handle_input("w", (0.0, 0.0), 0.25)
    assert ref.render_png() == png2


def test_preview_refinement():
    """Live input renders 1/2-resolution previews; at rest the viewer
    refines to the exact full frame, bytes equal to a preview-free viewer's
    and to the pipelined viewer's drained frame."""
    cfg = _config(width=128, height=64)
    state = _state(cfg, preview_scale=2)
    assert _dims(state.render_png()) == (128, 64)
    state.handle_input("w", (0.0, 0.0), 0.25)
    assert _dims(state.render_png()) == (64, 32)
    assert state.stats()["pending"]
    png3 = state.render_png()
    assert _dims(png3) == (128, 64) and not state.stats()["pending"]
    assert state.render_png() is png3
    ref = _state(cfg, preview_scale=1)
    ref.render_png()
    ref.handle_input("w", (0.0, 0.0), 0.25)
    assert ref.render_png() == png3
    piped = _state(cfg, preview_scale=2, pipeline=True)
    piped.render_png()
    piped.handle_input("w", (0.0, 0.0), 0.25)
    last = piped.render_png()
    for _ in range(6):
        if not piped.stats()["pending"]:
            break
        last = piped.render_png()
    assert not piped.stats()["pending"] and last == png3


def test_config_editing():
    """config.* rows: reflected values, coercion, reset to the dataclass
    default; a refused value raises and leaves the config and the frame as
    they were."""
    state = _state()
    props = {p["path"]: p for p in state.properties()}
    assert props["config.oetf"]["value"] == "srgb" and props["config.shadow_dim"]["value"] == "128"
    png_srgb = state.render_png()
    assert state.set_property("config.oetf", "pure_gamma") == "pure_gamma"
    assert state.render_png() != png_srgb
    assert state.set_property("config.oetf", "default") == "srgb"
    assert state.set_property("config.pcf_f16", "False") is False
    assert state.set_property("config.shadow_dim", "256") == 256
    before = state.config
    for field, value in (("tile_list_capacity", "-1"), ("oetf", "gamma"), ("shadow_dim", "100.5")):
        with pytest.raises(ValueError):
            state.set_config(field, value)
    assert state.config is before
    with pytest.raises(KeyError):
        state.set_config("no_such_field", "1")


def test_asset_loading(tmp_path):
    """/api/load: a .glb merged into the scene or replacing it (camera
    pose kept), builtin scene names, PNG textures with the sRGB choice
    (re-read in place), and a JPEG refused by name."""
    from syzygy_tpu_torch.assets.gltf_export import write_glb
    from syzygy_tpu_torch.assets.types import TextureLibrary
    from syzygy_tpu_torch.assets.defaults import register_default_textures, sphere_mesh

    library = TextureLibrary()
    glb = str(tmp_path / "ball.glb")
    write_glb(glb, [sphere_mesh(register_default_textures(library), rings=6, segments=8)], library)

    state = _state(pipeline=True)
    state.render_png()
    n_before, tris_before = len(state.scene.geometry), int(state._geometry_host["tri_valid"].sum())
    assert state.load_asset(glb, merge=True) == {"meshes": 1}
    assert len(state.scene.geometry) == n_before + 1
    assert int(state._geometry_host["tri_valid"].sum()) > tris_before
    assert state.render_png()[:4] == b"\x89PNG"

    tex = np.tile(np.array([[64, 128]], np.uint8), (2, 1))[..., None].repeat(4, -1)
    _write_png(tmp_path / "tex.png", tex)
    assert state.load_asset(str(tmp_path / "tex.png"), srgb=True) == {"texture": "tex.png", "srgb": True}
    idx = state.library.lookup("tex.png")
    assert state.library.is_srgb(idx)
    assert state.load_asset(str(tmp_path / "tex.png"), srgb=False)["srgb"] is False
    assert state.library.lookup("tex.png") == idx and not state.library.is_srgb(idx)
    np.testing.assert_allclose(state.library.get(idx)[0, 1], 128 / 255.0, atol=1e-6)

    (tmp_path / "photo.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="JPEG"):
        state.load_asset(str(tmp_path / "photo.jpg"))
    with pytest.raises(FileNotFoundError):
        state.load_asset(str(tmp_path / "missing.glb"))

    pos = state.scene.camera.position
    assert state.load_asset(glb, merge=False) == {"scene": "ball.glb"}
    assert len(state.scene.geometry) == 1 and tuple(state.scene.camera.position) == tuple(pos)
    assert state.load_asset("chessboard") == {"scene": "chessboard"}
    assert len(state.scene.geometry) > 1
    assert state.render_png()[:4] == b"\x89PNG"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(base, path, data=None, headers=None, method=None):
    """-> (status, body); an HTTP error status is returned, not raised."""
    req = urllib.request.Request(base + path, data=data, headers=headers or {}, method=method)
    try:
        with OPENER.open(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_up(base):
    for _ in range(100):
        try:
            return _request(base, "/")
        except OSError:
            time.sleep(0.1)
    raise RuntimeError("server did not come up")


@pytest.fixture(scope="module")
def port_server():
    """The port's viewer on the CPU, stopped after its frame limit."""
    from syzygy_tpu_torch.app.serve import serve
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, library = default_scene()
    port = _free_port()
    out = {}
    thread = threading.Thread(
        target=lambda: out.update(state=serve(scene, library, _config(), port=port, frames=2, device="cpu")),
        daemon=True,
    )
    thread.start()
    base = f"http://127.0.0.1:{port}"
    _wait_up(base)
    yield base, thread, out


@pytest.fixture(scope="module")
def reference_server():
    """The JAX package's viewer on the same scene (its routes that do not
    render a frame)."""
    from syzygy_tpu.app import serve as ref_serve
    from syzygy_tpu.renderer import RenderConfig as RefConfig
    from syzygy_tpu.scene import default_scene as ref_default

    scene, library = ref_default()
    port = _free_port()
    threading.Thread(
        target=ref_serve.serve, args=(scene, library, RefConfig(**SMALL)), kwargs={"port": port}, daemon=True
    ).start()
    base = f"http://127.0.0.1:{port}"
    _wait_up(base)
    return base


def test_http_layer(port_server, reference_server):
    """Routing over a real socket, as the reference's test drives it: the
    page, property and texture JSON equal to the reference viewer's, 404s,
    bad JSON 400, the cross-origin guard, a same-origin edit; then two
    frames, after which the server stops itself."""
    base, thread, out = port_server
    status, page = _request(base, "/")
    assert status == 200 and b"syzygy_tpu" in page and b"drawSpark" in page
    port_rows, ref_rows = (json.loads(_request(server, "/api/properties")[1]) for server in (base, reference_server))
    assert port_rows == _ported_rows(ref_rows)
    assert json.loads(_request(base, "/api/textures")[1]) == json.loads(_request(reference_server, "/api/textures")[1])
    for path in ("/texture.png?name=nope", "/no-such-route"):
        assert _request(base, path)[0] == 404
    assert _request(base, "/api/set", b"{not json")[0] == 400
    for headers in ({"Origin": "http://evil.example"}, {"Host": "evil.example"}):
        assert _request(base, "/api/load", b'{"path": "/etc/passwd"}', headers)[0] == 403
    port = base.rsplit(":", 1)[1]
    status, body = _request(base, "/api/set", b'{"path": "config.debug_lines", "value": "true"}',
                            {"Origin": f"http://127.0.0.1:{port}"})
    assert (status, json.loads(body)) == (200, {"value": "True"})
    status, body = _request(base, "/api/set", b'{"path": "config.debug_lines", "value": "default"}')
    assert (status, json.loads(body)) == (200, {"value": "False"})
    for _ in range(2):
        status, png = _request(base, "/frame.png")
        assert status == 200 and _dims(png) == (64, 32)
    thread.join(timeout=60)
    assert not thread.is_alive() and out["state"].dispatched >= 1


def test_ipv6_host_header_accepted(reference_server):
    """Not inherited: the reference cuts a ``Host`` at its last colon, so
    the portless IPv6 loopback ``[::1]`` becomes ``[:`` and its POSTs are
    refused (403); the port parses it as a host."""
    from syzygy_tpu_torch.app.serve import host_is_local

    body = b'{"path": "config.debug_lines", "value": "default"}'
    assert _request(reference_server, "/api/set", body, {"Host": "[::1]"})[0] == 403
    assert all(host_is_local(h) for h in ("[::1]", "[::1]:8731", "127.0.0.1", "localhost:80"))
    assert not any(host_is_local(h) for h in ("evil.example", "[::2]", "127.0.0.1.evil.example", "[::1"))


def test_refusals_answer_4xx(reference_server, tmp_path):
    """Not inherited: the reference answers a refused ``/api/set`` or
    ``/api/load`` with 200 and the exception text; the port's server
    answers 400 (404 for a missing file) with what was refused, and the
    refused edit changes nothing."""
    from syzygy_tpu_torch.app.serve import serve
    from syzygy_tpu_torch.scene.scene import default_scene

    bad_set = b'{"path": "camera.fov_degrees", "value": "wide"}'
    status, body = _request(reference_server, "/api/set", bad_set)
    assert status == 200 and "error" in json.loads(body)

    (tmp_path / "photo.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    scene, library = default_scene()
    port = _free_port()
    threading.Thread(
        target=serve, args=(scene, library, _config()), kwargs={"port": port, "device": "cpu"}, daemon=True
    ).start()
    base = f"http://127.0.0.1:{port}"
    _wait_up(base)
    cases = {
        bad_set: 400,
        b'{"path": "config.tile_list_capacity", "value": "-1"}': 400,
        b'{"path": "config.shadow_dim", "value": "100.5"}': 400,
        b'{"path": "cameras[7].fov_degrees", "value": "60"}': 400,
    }
    for data, code in cases.items():
        status, body = _request(base, "/api/set", data)
        assert status == code and "cannot set" in json.loads(body)["error"]
    for path, code, word in ((str(tmp_path / "photo.jpg"), 400, "JPEG"), (str(tmp_path / "nope.glb"), 404, "no such")):
        status, body = _request(base, "/api/load", json.dumps({"path": path}).encode())
        message = json.loads(body)["error"]
        assert status == code and word in message and "Traceback" not in message
    rows = {p["path"]: p["value"] for p in json.loads(_request(base, "/api/properties")[1])}
    assert rows["config.tile_list_capacity"] == "448" and rows["config.shadow_dim"] == "128"
    assert rows["cameras[0].fov_degrees"] == "70"
