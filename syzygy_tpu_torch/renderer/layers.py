"""The frame's layers, traced from inside the frame.

A frame runs eight contiguous layers, :data:`LAYERS`, in this order:
``state`` (frame state, vertex and normal transforms, light activity),
``shadow`` (the shadow-map slots), ``gbuffer`` (camera setup, raster,
resolve), ``lighting`` (the sun's shared PCF, deferred lighting),
``skyview_lut`` (the transmittance and sky-view LUTs), ``aerial_lut``
(t_seg rows, the aerial LUT, the f16 sampling copies), ``sky_pass`` (the
sky camera pass) and ``encode`` (debug lines, box filter, OETF, crop). A
frame without the atmosphere runs no sky layer; with ``aerial_lut=False``
the per-pixel sky integrals count as ``sky_pass``.

:func:`layer` opens a ``torch.profiler.record_function`` range named
``syzygy.<layer>`` around each, so an eager frame run under the profiler
shows its layers (a replay runs no Python and shows none), and marks the
layer's start to the recorder that :func:`recording` installs on the
thread, if any. ``renderer/frame.py`` installs a
:class:`FrameTrace` only while it captures a frame as a CUDA graph: its
marks become stamps in the graph (``kernels/stamp.py``), so every replay
writes its layers' device times into a ring, and nothing else stamps.

Spans: a layer's span is (name, start, end) on the device's clock (ns),
its parent the replay, named by its sequence number; the host's
``stage`` and ``replay`` spans of the same replay, which
``renderer/frame.py`` records, are (start, end) on the host's
``perf_counter`` (s). :meth:`FrameTrace.read` gives them per
finished replay, oldest first.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from syzygy_tpu_torch.kernels import stamp as stamps

LAYERS = ("state", "shadow", "gbuffer", "lighting", "skyview_lut", "aerial_lut", "sky_pass", "encode")
MARKS = len(LAYERS) + 1  # a frame's layer boundaries, at most
RING_REPLAYS = 4096  # replays a ring holds: 13 minutes of 200 ms frames

_local = threading.local()


@contextlib.contextmanager
def layer(name: str):
    """Layer ``name`` of the frame runs inside. Entered again while it is
    the open layer, it continues that layer."""
    with torch.profiler.record_function(f"syzygy.{name}"):
        recorder = getattr(_local, "recorder", None)
        if recorder is not None:
            recorder.enter(name)
        yield


@contextlib.contextmanager
def recording(recorder: FrameTrace):
    """Mark the layers of the one frame enqueued inside on ``recorder``:
    a mark as the frame starts, one as each further layer starts, and one
    as it ends."""
    if getattr(_local, "recorder", None) is not None:
        raise RuntimeError("a frame is already being recorded on this thread")
    _local.recorder = recorder
    try:
        recorder.begin()
        yield recorder
        recorder.end()
    finally:
        _local.recorder = None


class Replay(NamedTuple):
    """One finished replay: its sequence number, its layers' spans
    (name, start, end) on the device's clock (ns), and its host spans
    ``stage`` and ``replay`` (start, end) on the host's clock (s)."""

    seq: int
    layers: tuple
    stage: tuple
    replay: tuple

    @property
    def layer_ms(self) -> dict:
        return {name: (end - start) / 1e6 for name, start, end in self.layers}

    @property
    def stage_ms(self) -> float:
        return (self.stage[1] - self.stage[0]) * 1e3

    @property
    def replay_ms(self) -> float:
        return (self.replay[1] - self.replay[0]) * 1e3


def finished_replays(ring: np.ndarray, layers, host: np.ndarray, replays: int) -> list:
    """The :class:`Replay` of each of the last ``replays`` replays (at most
    a ring's rows) whose stamps are all written, oldest first. ``ring``:
    the device ring ((rows, MARKS + 1) int64, the last column each slot's
    sequence number); ``host``: (rows, 5) float64, each slot's sequence
    number and stage and replay spans. A slot holds replay ``s`` only where
    both hold ``s``: a slot still being written holds -1, one not yet
    reached an older replay's number."""
    rows = ring.shape[0]
    out = []
    for s in range(max(0, replays - rows), replays):
        dev, h = ring[s % rows], host[s % rows]
        if dev[-1] != s or h[0] != s:
            continue
        spans = tuple((name, int(dev[i]), int(dev[i + 1])) for i, name in enumerate(layers))
        out.append(Replay(s, spans, (float(h[1]), float(h[2])), (float(h[3]), float(h[4]))))
    return out


class FrameTrace:
    """The layer marks of one captured frame and the records of its
    replays, in rings of :data:`RING_REPLAYS` replays: on ``device``, the stamps
    (``ring``, column j mark j's time, the last column the sequence
    number; ``seq`` the replays finished); on the host, each replay's
    sequence number and ``stage`` and ``replay`` spans. While the frame is
    captured on a CUDA device, each mark also reads the graph's node
    count, so ``nodes`` holds each layer's nodes (its stamp left out),
    ``stamps`` and the graph's ``total``."""

    def __init__(self, device):
        self.ring = torch.full((RING_REPLAYS, MARKS + 1), -1, dtype=torch.int64, device=device)
        self.seq = torch.zeros((), dtype=torch.int64, device=device)
        self.host = np.full((RING_REPLAYS, 5), -1.0)
        self.replays = 0  # replays enqueued
        self.layers: list = []
        self.nodes: dict | None = None
        self._marks = 0
        self._counts: list = []  # graph nodes before each stamp

    def begin(self) -> None:
        self._mark(last=False)

    def enter(self, name: str) -> None:
        if self.layers and self.layers[-1] == name:
            return
        if name in self.layers or name not in LAYERS:
            raise ValueError(f"layer {name!r} out of place after {self.layers}")
        if self.layers:
            self._mark(last=False)
        self.layers.append(name)

    def end(self) -> None:
        self._mark(last=True)
        if self._counts:
            total = self._nodes()
            counts = self._counts + [total]
            self.nodes = {name: counts[i + 1] - counts[i] - 1 for i, name in enumerate(self.layers)}
            self.nodes.update(stamps=self._marks, total=total)

    def _nodes(self):
        return stamps.capture_nodes(self.ring.device) if self.ring.device.type == "cuda" else None

    def _mark(self, last: bool) -> None:
        count = self._nodes()
        if count is not None:
            self._counts.append(count)
        stamps.stamp(self.ring, self.seq, self._marks, last)
        self._marks += 1

    def replayed(self, stage: tuple, replay: tuple) -> None:
        """Record the host spans of the replay just enqueued, and count the
        stamps its graph launched."""
        self.host[self.replays % self.host.shape[0]] = (self.replays, *stage, *replay)
        self.replays += 1
        if self.nodes is not None:
            stamps.LAUNCHES.stamp += self.nodes["stamps"]

    def read(self) -> list:
        """The finished replays (:func:`finished_replays`). Copies the
        device ring to the host: read after the frames are done."""
        return finished_replays(self.ring.cpu().numpy(), self.layers, self.host, self.replays)
