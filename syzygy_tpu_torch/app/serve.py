"""Interactive browser viewer: the live-editing editor loop over HTTP.

Port of ``syzygy_tpu/app/serve.py``. The reference engine is a windowed
editor: GLFW input drives a fly camera (``editor/editor.cpp:441-779``) and
every scene parameter is live-editable with a per-row reset in ImGui
property tables (``ui/propertytable.hpp:28-226``). ``python -m
syzygy_tpu_torch.app --serve`` starts a localhost HTTP server whose one
page shows the rendered frame, takes WASDQE + drag fly-camera input (the
same ``Scene.handle_input`` as ``--input-script``) and lists the property
table (``app/properties.py``) with live edit and reset per row, the
``RenderConfig`` fields included.

Every rendered request runs the whole frame through
:func:`renderer.frame.render_frame_packed` on the state's device (the
raster kernel on the card). One lock serializes renders and edits. While
input is live, frames render at ``1/preview_scale`` resolution and the
exact full-resolution frame follows at rest; with ``pipeline`` (as
:func:`serve` runs it) a request that changes the frame answers with the
previous one and leaves the new one in flight, so the device works while
the host encodes and serves (two frames in flight,
``editor/framebuffer.cpp:134``).

Unlike the reference, refused edits and loads answer 4xx with what was
refused (the reference answers 200 with the exception text), a portless
IPv6 ``Host`` is parsed as a host, and only PNG images load as textures
(the stdlib codec of ``utils/png.py``); any other format is refused by
name. Standard library only: ``http.server`` and a self-contained page.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from syzygy_tpu_torch.app import properties
from syzygy_tpu_torch.device import as_device
from syzygy_tpu_torch.scene.pack import (
    flatten_frame_params,
    frame_param_spec,
    geometry_to_device,
    pack_frame_params,
    pack_geometry_host,
    scene_uses_metallic,
)
from syzygy_tpu_torch.utils.metrics import RingBuffer
from syzygy_tpu_torch.utils.png import decode_png, encode_png

log = logging.getLogger("syzygy")

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>syzygy_tpu_torch</title>
<style>
 body { background:#14161a; color:#cfd3da; font:13px monospace; margin:0;
        display:flex; height:100vh; }
 #view { flex:1; display:flex; flex-direction:column; align-items:center;
         justify-content:center; }
 #frame { image-rendering:pixelated; width:68vw; max-width:96%;
          border:1px solid #333; cursor:crosshair; }
 #hud { padding:6px; color:#8a8f98; }
 #panel { width:420px; overflow-y:auto; background:#1a1d22; padding:8px;
          border-left:1px solid #333; }
 table { border-collapse:collapse; width:100%; }
 td { padding:2px 4px; border-bottom:1px solid #24272c; }
 td.name { color:#7aa2f7; white-space:nowrap; max-width:200px;
           overflow:hidden; text-overflow:ellipsis; }
 input.val { width:140px; background:#0f1115; color:#cfd3da;
             border:1px solid #333; font:12px monospace; }
 button { background:#24272c; color:#cfd3da; border:1px solid #3a3f46;
          cursor:pointer; font:11px monospace; }
 #status { color:#9ece6a; }
</style></head><body>
<div id="view">
  <img id="frame" src="/frame.png?v=0" tabindex="0">
  <div id="hud">WASDQE move &middot; drag to look &middot;
    <span id="status">ready</span> &middot; <span id="perf"></span>
    <canvas id="spark" width="180" height="34"
      style="vertical-align:middle; border:1px solid #24272c;"
      title="FPS history (500-sample ring)"></canvas></div>
</div>
<div id="panel">
  <div id="loadbar" style="margin-bottom:6px;">
    <input id="loadpath" class="val" style="width:200px"
      placeholder="/path/to.glb, .png, or default|chessboard|flagship">
    <select id="loadmode"><option value="merge">merge</option>
      <option value="replace">replace</option></select>
    <label><input id="loadsrgb" type="checkbox" checked>sRGB</label>
    <button id="loadbtn">load</button>
  </div>
  <div id="texbar">
    <select id="texsel"><option value="">(inspect texture...)</option>
    </select>
  </div>
  <img id="texview" style="display:none; max-width:100%;
       image-rendering:pixelated; border:1px solid #333; margin:4px 0;">
  <table id="props"></table>
</div>
<script>
let v = 0, busy = false, pending = false;
const frame = document.getElementById('frame');
const status = document.getElementById('status');
function refresh() {
  if (busy) { pending = true; return; }
  busy = true; status.textContent = 'rendering...';
  const img = new Image();
  img.onload = async () => { frame.src = img.src; busy = false;
    // #frame has a FIXED relative width (68vw) so preview frames and
    // config resolution changes all scale into the same display box
    // (the reference scales its viewport image to the window too)
    status.textContent = 'ready';
    try {  // performance window analog: frame ms + FPS ring report
      const s = await (await fetch('/api/stats')).json();
      document.getElementById('perf').textContent =
        s.last_ms.toFixed(0) + ' ms | fps ' + (s.fps || '-');
      drawSpark(s.fps_samples);
      // drain the 2-frames-in-flight pipeline when input stops
      if (s.pending) pending = true;
    } catch (e) {}
    if (pending) { pending = false; refresh(); } };
  img.onerror = () => { busy = false; status.textContent = 'error'; };
  img.src = '/frame.png?v=' + (++v);
}
async function post(url, body) {
  const r = await fetch(url, {method:'POST', body:JSON.stringify(body)});
  return r.json();
}
// FPS sparkline (the ImPlot performance graph, statelesswidgets.cpp:98-161)
function drawSpark(samples) {
  const c = document.getElementById('spark'), ctx = c.getContext('2d');
  ctx.clearRect(0, 0, c.width, c.height);
  if (!samples || samples.length < 2) return;
  const max = Math.max(...samples), min = Math.min(...samples);
  const span = Math.max(max - min, 1e-6);
  ctx.strokeStyle = '#9ece6a'; ctx.lineWidth = 1; ctx.beginPath();
  samples.forEach((v, i) => {
    const x = i / (samples.length - 1) * (c.width - 2) + 1;
    const y = c.height - 2 - (v - min) / span * (c.height - 4);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
}
// runtime asset loading (the reference's mid-session file dialogs)
document.getElementById('loadbtn').onclick = async () => {
  const path = document.getElementById('loadpath').value.trim();
  if (!path) return;
  status.textContent = 'loading...';
  const r = await post('/api/load', {
    path: path,
    merge: document.getElementById('loadmode').value === 'merge',
    srgb: document.getElementById('loadsrgb').checked,
  });
  if (r.error) { status.textContent = r.error; return; }
  status.textContent = 'loaded ' + JSON.stringify(r);
  loadProps(); loadTextures(); refresh();
};
// fly camera: keys + mouse drag through the InputHandler path
const keys = new Set();
addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT') return;
  const k = e.key.toLowerCase();
  if ('wasdqe'.includes(k)) { keys.add(k); e.preventDefault(); }
});
addEventListener('keyup', e => keys.delete(e.key.toLowerCase()));
setInterval(async () => {
  if (keys.size === 0) return;
  await post('/api/input', {keys: Array.from(keys).join(''), dt: 0.12});
  refresh();
}, 140);
let dragging = false, lx = 0, ly = 0;
frame.addEventListener('mousedown', e => {
  dragging = true; lx = e.clientX; ly = e.clientY; });
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', async e => {
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  if (Math.abs(dx) + Math.abs(dy) < 3) return;
  lx = e.clientX; ly = e.clientY;
  await post('/api/input', {cursor: [dx, dy], dt: 0.0});
  refresh();
});
// property table: name / value / reset (propertytable.hpp's 3 columns)
async function loadProps() {
  const props = await (await fetch('/api/properties')).json();
  const tbl = document.getElementById('props');
  tbl.innerHTML = '';
  for (const p of props) {
    const tr = document.createElement('tr');
    const name = document.createElement('td');
    name.className = 'name'; name.textContent = p.path; name.title = p.path;
    const val = document.createElement('td');
    const inp = document.createElement('input');
    inp.className = 'val'; inp.value = p.value;
    inp.addEventListener('keydown', async e => {
      if (e.key !== 'Enter') return;
      const r = await post('/api/set', {path: p.path, value: inp.value});
      if (r.error) { status.textContent = r.error; inp.value = p.value; }
      else { p.value = r.value; inp.value = r.value; refresh(); }
    });
    val.appendChild(inp);
    const rst = document.createElement('td');
    if (p.default !== null) {
      const b = document.createElement('button');
      b.textContent = '\\u21ba';
      b.title = 'reset to ' + p.default;
      b.onclick = async () => {
        const r = await post('/api/set', {path: p.path, value: 'default'});
        if (!r.error) { p.value = r.value; inp.value = r.value; refresh(); }
      };
      rst.appendChild(b);
    }
    tr.append(name, val, rst); tbl.appendChild(tr);
  }
}
loadProps();
// TextureDisplay analog (ui/texturedisplay.cpp:21-80): any registered
// asset, shown at native resolution in the side panel
async function loadTextures() {
  const texs = await (await fetch('/api/textures')).json();
  const sel = document.getElementById('texsel');
  sel.innerHTML = '<option value="">(inspect texture...)</option>';
  for (const t of texs) {
    const o = document.createElement('option');
    o.value = t.name; o.textContent = t.name + ' (' + t.w + 'x' + t.h + ')';
    sel.appendChild(o);
  }
  sel.onchange = () => {
    const img = document.getElementById('texview');
    if (!sel.value) { img.style.display = 'none'; return; }
    img.src = '/texture.png?name=' + encodeURIComponent(sel.value);
    img.style.display = 'block';
  };
}
loadTextures();
</script></body></html>
"""


# the exceptions an edit or a load raises when what it was given is wrong;
# anything else is a fault of the viewer and answers 500
REFUSED = (KeyError, IndexError, AttributeError, ValueError, TypeError)
_LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1")
# leading bytes of the image formats a texture load names when it refuses them
_IMAGE_MAGIC = (
    (b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "RIFF (WebP)"),
)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_bytes(image) -> bytes:
    """(H, W, 3) float [0, 1] or uint8 -> PNG bytes at the fastest deflate
    level: a frame is viewed once and its encode is on the request path."""
    return encode_png(np.asarray(image), compress_level=1)


def read_texture_png(path: str) -> np.ndarray:
    """A texture file -> (H, W, 4) uint8. Only PNG decodes here; another
    image format raises a ValueError that names it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        fmt = next((name for magic, name in _IMAGE_MAGIC if data.startswith(magic)), None)
        fmt = fmt or (os.path.splitext(path)[1].lstrip(".").upper() or "unknown")
        raise ValueError(f"{os.path.basename(path)}: {fmt} images are not supported (only PNG)")
    return decode_png(data)


def host_is_local(host_header: str) -> bool:
    """Is a ``Host`` header one of this machine's loopback names, with or
    without a port? ``urlsplit`` parses ``[::1]`` and ``[::1]:8731`` alike
    (the reference cut at the last colon and turned ``[::1]`` into
    ``[:``)."""
    try:
        return urlsplit("//" + host_header).hostname in _LOCAL_HOSTS
    except ValueError:
        return False


class _State:
    """Render state shared by the request threads; one lock serializes
    renders and scene edits (the editor loop is single-threaded too)."""

    def __init__(
        self, scene, library, config, mipmaps=False, dt=1.0 / 60.0, pipeline=False, preview_scale=1,
        device="cuda",
    ):
        config.check()
        self.lock = threading.Lock()
        self.device = as_device(device)
        self.scene = scene
        self.library = library
        self.config = config
        self.mipmaps = mipmaps
        self.dt = dt
        self.aspect = config.width / config.height
        self._repack()
        self._frame_png = None
        self._dirty = True
        self._fps = None
        self._last_ms = 0.0
        self.dispatched = 0  # frames dispatched (rendered), full and preview
        # Two frames in flight: a dirty request dispatches the new frame and
        # answers with the previous one; the next request fetches the
        # finished dispatch. stats()["pending"] tells the page to drain.
        self.pipeline = pipeline
        self._pending = None
        # Progressive preview: 1/preview_scale resolution while input keeps
        # the scene dirty, then one exact full-resolution frame at rest.
        self.preview_scale = max(1, int(preview_scale))
        self._preview_config = None
        self._needs_full = False
        self._rebuild_preview()

    def _repack(self) -> None:
        """Pack the scene's geometry and put it on the device."""
        self._geometry_host = pack_geometry_host(self.scene, self.library, mipmaps=self.mipmaps)
        self.geometry = geometry_to_device(self._geometry_host, self.device)

    def _rebuild_preview(self) -> None:
        """The preview config of the current full config: both dimensions
        divided by one scale (the aspect kept to integer rounding); none
        when it would not shrink."""
        self._preview_config = None
        if self.preview_scale > 1:
            pw = max(1, self.config.width // self.preview_scale)
            ph = max(1, self.config.height // self.preview_scale)
            if (pw, ph) != (self.config.width, self.config.height):
                self._preview_config = dataclasses.replace(self.config, width=pw, height=ph, sky_row_chunks=0)

    def _dispatch(self, cfg):
        """Render one frame of the current scene at ``cfg``: the encoded
        frame on the device, not yet fetched."""
        from syzygy_tpu_torch.renderer.frame import render_frame_packed

        params = pack_frame_params(self.scene, self.aspect)
        spec = frame_param_spec(params)
        flat = flatten_frame_params(params, spec, np.empty(spec.total, np.float32))
        self.dispatched += 1
        return render_frame_packed(self.geometry, flat, spec, cfg)

    def render_png(self) -> bytes:
        from syzygy_tpu_torch.runtime import fetch_frame_u8

        with self.lock:
            if not self._dirty and not self._needs_full and self._frame_png is not None and self._pending is None:
                return self._frame_png
            t0 = time.perf_counter()
            cfg = None
            if self._dirty or (self._frame_png is None and self._pending is None):
                # live input renders the preview (never the first frame, so
                # the page sizes itself from a full-resolution frame)
                preview = self._preview_config is not None and self._dirty and self._frame_png is not None
                cfg = self._preview_config if preview else self.config
                self._dirty = False
                self._needs_full = preview
            elif self._needs_full and self._pending is None:
                # input stopped: refine to the exact full-resolution frame
                cfg = self.config
                self._needs_full = False
            if self._pending is not None:
                # fetch the frame dispatched by the previous request first:
                # on the card's one stream its copy would otherwise wait
                # for the new frame too
                pend, self._pending = self._pending, None
                try:
                    image = fetch_frame_u8(pend)
                except RuntimeError:
                    # a failed frame surfaces here: drop it so the next
                    # request dispatches again
                    self._dirty = True
                    raise
                self._pending = self._dispatch(cfg) if cfg is not None else None
            else:
                fut = self._dispatch(cfg)
                if self.pipeline and self._frame_png:
                    # leave the new frame in flight and answer with the
                    # previous one (not a frame time: no FPS sample)
                    self._pending = fut
                    return self._frame_png
                image = fetch_frame_u8(fut)  # cold first frame, or no pipelining
            self._note_frame_time(t0)
            self._frame_png = _png_bytes(image)
            return self._frame_png

    def _note_frame_time(self, t0) -> None:
        self._last_ms = (time.perf_counter() - t0) * 1e3
        if self._fps is not None:  # the first frame builds and loads the kernels
            self._fps.write(1e3 / max(self._last_ms, 1e-6))
        else:
            self._fps = RingBuffer()

    def stats(self):
        """The performance window (``ui/statelesswidgets.cpp:98-161``):
        frame ms, the FPS ring's report and samples, the Draw Results
        counters, and whether a frame is still owed."""
        from syzygy_tpu_torch.renderer.stats import frame_draw_stats

        with self.lock:
            params = pack_frame_params(self.scene, self.aspect)
            draw = {
                name: str(stat)
                for name, stat in frame_draw_stats(params, self._geometry_host, self.config).items()
            }
            return {
                "last_ms": self._last_ms,
                "fps": None if self._fps is None else self._fps.report(),
                "fps_samples": [] if self._fps is None else self._fps.history(),
                "draw_results": draw,
                "pending": self._pending is not None or self._needs_full,
                "dispatched": self.dispatched,
            }

    def handle_input(self, keys: str, cursor, dt: float):
        with self.lock:
            self.scene.handle_input(
                dt if dt > 0.0 else self.dt, cursor_delta=tuple(cursor), keys=frozenset(keys)
            )
            if dt > 0.0:
                self.scene.tick(dt)
            self._dirty = True

    def set_config(self, name: str, value):
        """Live ``RenderConfig`` editing (the pipeline editor,
        ``ui/pipelineui.cpp:43-424``). The new config is validated whole
        before it is installed: a refused value leaves the running config
        as it was."""
        with self.lock:
            new = properties.apply_config_field(self.config, name, value)
            self.config = new
            self.aspect = new.width / new.height
            self._rebuild_preview()
            self._pending = None
            self._dirty = True
            return getattr(self.config, name)

    def set_property(self, path: str, value):
        if path.startswith("config."):
            return self.set_config(path[len("config."):], value)
        with self.lock:
            path = properties.canonical_path(self.scene, path)
            if isinstance(value, str) and value.strip() == "default":
                properties.reset_path(self.scene, path)
            else:
                if isinstance(value, str):
                    value = properties.parse_value(value)
                properties.set_path(self.scene, path, value)
            # transforms and visibility feed the packed instance tables
            self._repack()
            self._dirty = True
            return properties.get_path(self.scene, path)

    def textures(self):
        """The texture inspector's list (``ui/texturedisplay.cpp:21-80``):
        every registered texture at its native size."""
        with self.lock:
            out = []
            for name in self.library.names():
                idx = self.library.lookup(name)
                h, w = self.library.get(idx).shape[:2]
                out.append({"name": name, "index": idx, "w": int(w), "h": int(h)})
            return out

    def texture_png(self, name: str) -> bytes:
        from syzygy_tpu_torch.assets.types import linear_to_srgb

        with self.lock:
            idx = self.library.lookup(name)
            if idx is None:
                raise KeyError(f"no texture named {name!r}")
            img = self.library.get(idx)[..., :3]
            if self.library.is_srgb(idx):
                # color maps were sRGB-decoded when registered: encode them
                # again so they show at their source brightness
                img = linear_to_srgb(img)
            return _png_bytes(img)

    def load_asset(self, path: str, srgb: bool = True, merge: bool = True):
        """Runtime asset loading (the reference's mid-session file dialogs,
        ``assets/assets.cpp:1615-1667``, ``ui/uiwidgets.hpp:74-99``):

        * a builtin scene name (``default``, ``sphere``, ``chessboard``,
          ``flagship``) replaces the scene, as ``--scene`` would;
        * ``.glb``/``.gltf``: ``merge`` adds the file's meshes as new
          instances of the current scene, otherwise the file replaces the
          scene; a replaced scene keeps the camera's pose;
        * a PNG image registers (or re-reads) a texture with the given
          sRGB flag.

        The geometry is packed again and put on the device before this
        returns; the next frame shows the new content."""
        from syzygy_tpu_torch.app.scenes import BUILTIN_SCENES, builtin_scene

        ext = os.path.splitext(path)[1].lower()
        with self.lock:
            if path in BUILTIN_SCENES:
                scene, library = builtin_scene(path)
                scene.tick(0.0)
                self._adopt(scene, library)
                loaded = {"scene": path}
            elif ext in (".glb", ".gltf"):
                from syzygy_tpu_torch.assets.gltf import load_gltf_meshes, load_gltf_scene

                if merge:
                    from syzygy_tpu_torch.scene.scene import TransformHost

                    meshes, _ = load_gltf_meshes(path, self.library)
                    base = os.path.splitext(os.path.basename(path))[0]
                    for i, mesh in enumerate(meshes):
                        self.scene.add_mesh_instance(mesh, f"{base}_{i}", [TransformHost.make((0.0, 0.0, 0.0))])
                    loaded = {"meshes": len(meshes)}
                else:
                    self._adopt(*load_gltf_scene(path))
                    loaded = {"scene": os.path.basename(path)}
            else:
                name = os.path.basename(path)
                # replace: loading a name again re-reads texels and flag
                self.library.register(name, read_texture_png(path), srgb=srgb, replace=True)
                loaded = {"texture": name, "srgb": srgb}
            # metallic_reflection follows the content (exact zero skip)
            self.config = dataclasses.replace(
                self.config, metallic_reflection=scene_uses_metallic(self.scene, self.library)
            )
            self._rebuild_preview()
            self._repack()
            self._pending = None  # a frame in flight shows the old content
            self._dirty = True
            return loaded

    def _adopt(self, scene, library) -> None:
        """Install a new scene, carrying the camera pose over."""
        old = self.scene.camera
        scene.camera.position = old.position
        scene.camera.euler_angles = old.euler_angles
        self.scene, self.library = scene, library

    def properties(self):
        with self.lock:
            rows = [
                {"path": p.path, "value": properties._fmt(p.value),
                 "default": None if p.default is None else properties._fmt(p.default)}
                for p in properties.discover(self.scene)
            ]
            rows += [
                {"path": f"config.{f.name}", "value": properties._fmt(getattr(self.config, f.name)),
                 "default": properties._fmt(f.default)}
                for f in dataclasses.fields(type(self.config))
            ]
            return rows


class _Counter:
    """Frames served, shared by the request threads; ``done`` is set once
    ``limit`` (> 0) frames were served."""

    def __init__(self, limit: int):
        self.limit = limit
        self.count = 0
        self.lock = threading.Lock()
        self.done = threading.Event()

    def add(self) -> None:
        with self.lock:
            self.count += 1
            if 0 < self.limit <= self.count:
                self.done.set()


def serve(scene, library, config, port=8731, mipmaps=False, frames=0, preview_scale=2, device="cuda"):
    """Run the interactive viewer on ``127.0.0.1:port`` until interrupted,
    or until ``frames`` (> 0) frames were served; returns its state.

    ``preview_scale``: while input is live, frames render at
    1/preview_scale resolution and refine to the exact full-resolution
    frame when input stops (1 disables). On the card the raster kernel is
    built and loaded before the server takes a request."""
    state = _State(
        scene, library, config, mipmaps=mipmaps, pipeline=True, preview_scale=preview_scale, device=device
    )
    if state.device.type == "cuda":
        from syzygy_tpu_torch.kernels import build

        build.load("raster")
    served = _Counter(frames)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug("serve: " + fmt, *args)

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _refuse(self, code, message):
            self._send(code, json.dumps({"error": message}).encode())

        def do_GET(self):
            route = urlsplit(self.path)
            if route.path == "/":
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif route.path == "/frame.png":
                try:
                    png = state.render_png()
                except Exception as e:  # report the failed frame, keep serving
                    log.exception("render failed")
                    self._send(500, f"render failed: {type(e).__name__}: {e}".encode(), "text/plain")
                    return
                self._send(200, png, "image/png")
                served.add()
            elif route.path == "/api/properties":
                self._send(200, json.dumps(state.properties()).encode())
            elif route.path == "/api/stats":
                self._send(200, json.dumps(state.stats()).encode())
            elif route.path == "/api/textures":
                self._send(200, json.dumps(state.textures()).encode())
            elif route.path == "/texture.png":
                try:
                    png = state.texture_png(parse_qs(route.query).get("name", [""])[0])
                except KeyError as e:
                    self._send(404, str(e).encode(), "text/plain")
                    return
                self._send(200, png, "image/png")
            else:
                self._send(404, b"not found", "text/plain")

        def _origin_ok(self):
            """Refuse cross-site POSTs: /api/load reads local files and
            /api/set edits the session, and a browser sends simple fetch()
            POSTs cross-origin without preflight. So the Host must be a
            loopback name (against DNS rebinding) and so must an Origin,
            where the browser sends one."""
            if not host_is_local(self.headers.get("Host") or ""):
                return False
            origin = self.headers.get("Origin")
            return not origin or host_is_local(urlsplit(origin).netloc)

        def do_POST(self):
            if not self._origin_ok():
                self._refuse(403, "cross-origin request")
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                self._refuse(400, "bad json")
                return
            if not isinstance(body, dict):
                self._refuse(400, "expected a JSON object")
                return
            if self.path == "/api/input":
                try:
                    state.handle_input(
                        str(body.get("keys", "")), body.get("cursor", (0.0, 0.0)), float(body.get("dt", 0.0))
                    )
                except (TypeError, ValueError) as e:
                    self._refuse(400, f"bad input: {e}")
                    return
                self._send(200, b'{"ok": true}')
            elif self.path == "/api/set":
                path = body.get("path", "")
                try:
                    value = state.set_property(path, body.get("value"))
                except REFUSED as e:
                    self._refuse(400, f"cannot set {path!r}: {type(e).__name__}: {e}")
                    return
                self._send(200, json.dumps({"value": properties._fmt(value)}).encode())
            elif self.path == "/api/load":
                path = str(body.get("path", ""))
                try:
                    loaded = state.load_asset(path, srgb=bool(body.get("srgb", True)), merge=bool(body.get("merge", True)))
                except FileNotFoundError:
                    self._refuse(404, f"cannot load {path!r}: no such file")
                    return
                except (OSError, *REFUSED) as e:
                    log.info("load of %r refused", path, exc_info=True)
                    self._refuse(400, f"cannot load {path!r}: {type(e).__name__}: {str(e)[:200]}")
                    return
                self._send(200, json.dumps(loaded).encode())
            else:
                self._refuse(404, "not found")

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    log.info("interactive viewer on http://127.0.0.1:%d (%dx%d on %s, ctrl-c to stop)",
             port, config.width, config.height, state.device)
    try:
        if frames > 0:
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            served.done.wait()
            httpd.shutdown()
            thread.join()
        else:
            httpd.serve_forever()
    except KeyboardInterrupt:
        log.info("viewer stopped")
    finally:
        httpd.server_close()
    return state
