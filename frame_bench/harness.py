"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the scene module (``scenes/<scene>.py``), the
  render settings as run, the camera and the sun;
* ``traffic/<traffic>.json``: the parameters of the one loop below (frames
  in flight, scene time per frame, camera orbit, frames checked, frames
  traced);
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of the
  :class:`Run` record;
* ``checks/<workload>.json``: the limits of the comparison with the
  reference (:mod:`frame_bench.check`).

The system under test is the port's frame entry,
``syzygy_tpu_torch.renderer.frame.render_frame_packed``, on geometry from
``scene.pack.pack_geometry`` and one params row per frame packed inside the
window (``pack_frame_params`` + ``flatten_frame_params``), as the port's app
and viewer pack theirs. A frame counts once its image is in host memory.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import json
import os
import time
import types
from contextlib import contextmanager

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


# ---------------------------------------------------------------------------
# the cell, from BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    workload: dict  # the BENCHMARK.json entry
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # checks/<workload>.json
    end_to_end: list  # the BENCHMARK.json metrics this cell reports, with --trace 0
    per_layer: list  # ... and with --trace 1


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def _read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json and its files."""
    bench = _read_json(root, "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    workload = found[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root, configs[workload["config"]]["file"])
    traffic = _read_json(BENCH_DIR, "traffic", workload["traffic"] + ".json")
    limits = _read_json(BENCH_DIR, "checks", name + ".json")
    return Cell(
        workload, config, traffic, limits,
        [m for m in bench["end_to_end"] if _reports(m, name)],
        [m for m in bench["per_layer"] if _reports(m, name)],
    )


# ---------------------------------------------------------------------------
# the two renderers' public scene APIs, under the same names
# ---------------------------------------------------------------------------


def port_api():
    """The port: the system under test."""
    from syzygy_tpu_torch.assets.gltf import GLTFFile, gltf_scene
    from syzygy_tpu_torch.assets.types import GeometrySurface, MaterialData, Mesh, TextureLibrary
    from syzygy_tpu_torch.renderer.frame import RenderConfig, captured_frames, render_frame_packed
    from syzygy_tpu_torch.scene.pack import (
        flatten_frame_params,
        frame_param_spec,
        pack_frame_params,
        pack_geometry,
    )
    from syzygy_tpu_torch.scene.scene import Scene, TransformHost, look_at_transform

    return types.SimpleNamespace(**locals())


def reference_api():
    """The plain reference (:mod:`frame_bench.reference`)."""
    from frame_bench.reference.assets.gltf import GLTFFile, gltf_scene
    from frame_bench.reference.assets.types import GeometrySurface, MaterialData, Mesh, TextureLibrary
    from frame_bench.reference.renderer.frame import RenderConfig, render_frame
    from frame_bench.reference.scene.pack import pack_frame_params, pack_geometry, upload_frame_params
    from frame_bench.reference.scene.scene import Scene, TransformHost, look_at_transform

    return types.SimpleNamespace(**locals())


def scene_module(config: dict):
    return importlib.import_module(f"frame_bench.scenes.{config['scene']}")


# ---------------------------------------------------------------------------
# the traffic: each frame's input, from the seed and the frame's number
# ---------------------------------------------------------------------------


class Inputs:
    """Frame k's scene time, sun and camera. Frame 0 is the set-up's
    warm-up frame, frames 1, 2, ... the window's; the scene is ticked by
    ``dt_s`` before each frame after the first. The seed draws the sun's
    starting time of day (where the configuration gives a range) and the
    orbit's starting azimuth (where the traffic orbits)."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        rng = np.random.default_rng(seed)
        sun = config["sun"]
        self.sun_time = float(rng.uniform(*sun["time"])) if isinstance(sun["time"], list) else float(sun["time"])
        self.sun_speed, self.sun_frozen = float(sun["speed"]), bool(sun["frozen"])
        self.dt = float(traffic["dt_s"])
        self.orbit = float(traffic["orbit_deg_per_s"])
        self.eye = np.asarray(config["camera"]["eye"], np.float64)
        self.target = np.asarray(config["camera"]["target"], np.float64)
        self.azimuth0 = float(rng.uniform(0.0, 360.0)) if self.orbit else 0.0

    def pose(self, k: int):
        """(position, euler angles) of frame k's camera, f32 values."""
        from frame_bench.reference.math.geometry import eulers_from_forward

        eye = self.eye
        if self.orbit:
            offset = self.eye - self.target
            radius = float(np.hypot(offset[0], offset[2]))
            az = np.radians(self.azimuth0 + self.orbit * self.dt * k)
            eye = self.target + np.array([radius * np.cos(az), offset[1], radius * np.sin(az)])
        eye32 = eye.astype(np.float32)
        forward = torch.from_numpy(self.target.astype(np.float32) - eye32)
        return tuple(float(x) for x in eye32), tuple(eulers_from_forward(forward).tolist())

    def start(self, scene) -> None:
        """Put ``scene`` at frame 0."""
        anim = scene.sun_animation
        anim.time, anim.speed, anim.frozen = self.sun_time, self.sun_speed, self.sun_frozen
        scene.tick(0.0)
        self._camera(scene, 0)

    def step(self, scene, k: int) -> None:
        """Advance ``scene`` from frame k - 1 to frame k."""
        scene.tick(self.dt)
        self._camera(scene, k)

    def _camera(self, scene, k: int) -> None:
        scene.camera.position, scene.camera.euler_angles = self.pose(k)


# ---------------------------------------------------------------------------
# spans: the harness's own, around each call it makes into a layer
# ---------------------------------------------------------------------------


class Spans:
    """Host-clock spans (name, frame, start, end) kept in memory; each
    also opens a ``torch.profiler.record_function`` of the same name, so
    that a traced stretch sees them beside the device's operations."""

    def __init__(self):
        self.records: list = []

    @contextmanager
    def __call__(self, name: str, frame: int):
        with torch.profiler.record_function(f"frame_bench.{name}.{frame}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.records.append((name, frame, t0, time.perf_counter()))

    def mean_ms(self, name: str, frames) -> float | None:
        frames = set(frames)
        values = [(t1 - t0) * 1e3 for n, k, t0, t1 in self.records if n == name and k in frames]
        return sum(values) / len(values) if values else None


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Frame:
    k: int
    t_input: float  # host clock when the frame's input was taken
    t_done: float = float("nan")  # ... when its image was in host memory
    counted: bool = False  # the image reached host memory inside the window
    started: object = None  # CUDA event as the frame's issue began (timing on the device's clock)
    event: object = None  # CUDA event after the frame's copy to the host
    slot: object = None  # ("ring", i) or ("keep", j)


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: Cell
    seed: int
    setup_s: float
    window_s: float
    frames: list
    spans: Spans
    memory_peak_bytes: int | None
    graph: dict | None  # captured_frames()' entry of the cell's graph
    trace: object = None  # frame_bench.trace.Stretch of a --trace 1 run
    kept: dict = dataclasses.field(default_factory=dict)  # frame k -> its host image
    setup_stages: dict = dataclasses.field(default_factory=dict)  # set-up stage -> seconds from the start
    roofline: object = None  # frame_bench.roofline.Work of the traced frames

    @property
    def counted(self) -> list:
        return [f for f in self.frames if f.counted]

    @property
    def untraced(self) -> list:
        """The counted frames before the profiler started: it slows the
        host's issue of the frames it runs over and of those after it."""
        first = self.trace.profiled[0] if self.trace is not None else float("inf")
        return [f for f in self.counted if f.k < first]


def _marker():
    """A timing CUDA event recorded on the current stream (a host that
    waits for it spins, as the port's own staging ring does)."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _HostCopies:
    """Where each frame's image lands on the host: a ring of
    ``in_flight`` buffers, and ``keep`` buffers that hold the frames
    drawn for the check (reservoir sampling from the seed, decided before
    the frame is issued), so keeping a frame costs no extra copy."""

    def __init__(self, shape, in_flight: int, keep: int, seed: int, device):
        self.cuda = device.type == "cuda"
        pin = self.cuda

        def buf():
            return torch.empty(shape, dtype=torch.float32, pin_memory=pin)

        self.ring = [buf() for _ in range(in_flight)]
        self.keep = [buf() for _ in range(keep)]
        self.kept: list = [None] * keep  # frame k held by each keep buffer
        self.rng = np.random.default_rng([seed, 1])
        self.seen = 0
        self.next_ring = 0

    def slot(self, k: int):
        n = self.seen
        self.seen += 1
        j = n if n < len(self.keep) else int(self.rng.integers(0, n + 1))
        if j < len(self.keep):
            self.kept[j] = k
            return ("keep", j)
        i = self.next_ring
        self.next_ring = (i + 1) % len(self.ring)
        return ("ring", i)

    def buffer(self, slot):
        kind, i = slot
        return self.keep[i] if kind == "keep" else self.ring[i]

    def start(self, frame: Frame) -> None:
        """Mark on the stream where the frame's work begins."""
        if self.cuda:
            frame.started = _marker()

    def copy(self, image, frame: Frame) -> None:
        dst = self.buffer(frame.slot)
        if self.cuda:
            dst.copy_(image, non_blocking=True)
            frame.event = _marker()
        else:
            dst.copy_(image)

    def images(self) -> dict:
        return {k: self.keep[j].numpy() for j, k in enumerate(self.kept) if k is not None}


def run_cell(
    cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
    render_overrides: dict | None = None, render=None,
) -> Run:
    """Set-up, warm-up and the measured window of one run: the scene from
    the benchmark's inputs through the port's public API, its geometry
    packed once, the port's RenderConfig as the configuration states it
    (with ``render_overrides``: the control). ``render`` stands in for
    the port's frame entry (tests plant faults with it)."""
    stages = {"imports": time.perf_counter() - t_start}
    api = port_api()
    module = scene_module(cell.config)
    scene, library = module.build(api, module.inputs())
    inputs = Inputs(cell.config, cell.traffic, seed)
    inputs.start(scene)
    config = api.RenderConfig(**{**cell.config["render"], **(render_overrides or {})})
    geometry = api.pack_geometry(scene, library, device)
    stages["scene_and_geometry"] = time.perf_counter() - t_start
    render = render or api.render_frame_packed
    cuda = device.type == "cuda"
    aspect = config.width / config.height
    params = api.pack_frame_params(scene, aspect)
    spec = api.frame_param_spec(params)
    row = api.flatten_frame_params(params, spec)
    # warm-up of the cell's one shape: an eager frame and the graph
    # capture, then one replay and its copy to the host
    traffic = cell.traffic
    image = render(geometry, row, spec, config)
    if cuda:
        torch.cuda.synchronize(device)
    stages["eager_frame_and_capture"] = time.perf_counter() - t_start
    copies = _HostCopies(tuple(image.shape), int(traffic["in_flight"]), int(traffic["check_frames"]), seed, device)
    copies.ring[0].copy_(render(geometry, row, spec, config), non_blocking=cuda)
    del image
    if cuda:
        torch.cuda.synchronize(device)
    stages["first_replay"] = time.perf_counter() - t_start
    spans = Spans()
    frames: list = []
    pending: collections.deque = collections.deque()
    in_flight = int(traffic["in_flight"])
    tracer = None
    if trace:
        from frame_bench.trace import Tracer

        tracer = Tracer(int(traffic["trace_after_frames"]), int(traffic["trace_frames"]))

    def finish(frame: Frame, deadline: float) -> None:
        with spans("fetch_wait", frame.k):
            if frame.event is not None:
                frame.event.synchronize()
        frame.t_done = time.perf_counter()
        frame.counted = frame.t_done <= deadline
        if tracer is not None:
            tracer.done(frame.k)

    t_open = time.perf_counter()
    setup_s = t_open - t_start
    deadline = t_open + seconds
    k = 0
    while time.perf_counter() < deadline:
        k += 1
        if tracer is not None:
            tracer.before(k)
        frame = Frame(k, time.perf_counter(), slot=copies.slot(k))
        with spans("pack", k):
            inputs.step(scene, k)
            api.flatten_frame_params(api.pack_frame_params(scene, aspect), spec, row)
        with spans("issue", k):
            copies.start(frame)
            image = render(geometry, row, spec, config)
            copies.copy(image, frame)
            del image
        frames.append(frame)
        pending.append(frame)
        while len(pending) >= in_flight:
            finish(pending.popleft(), deadline)
    while pending:
        finish(pending.popleft(), deadline)
    if cuda:
        torch.cuda.synchronize(device)
    window_s = max((f.t_done for f in frames if f.counted), default=t_open) - t_open
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else None
    graph = None
    if cuda:
        graphs = [g for g in api.captured_frames() if g["config"] == config]
        graph = graphs[-1] if graphs else None
    run = Run(cell, seed, setup_s, window_s, frames, spans, peak, graph)
    run.kept = copies.images()
    run.setup_stages = stages
    if tracer is not None:
        run.trace = tracer.stretch()
    return run
