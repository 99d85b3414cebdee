"""The frame's layers, traced from inside the frame.

A frame runs contiguous layers of :data:`LAYERS`, in this order:
``state`` (frame state, vertex and normal transforms, light activity),
``shadow`` (the shadow-map slots), ``gbuffer`` (camera setup, raster,
resolve), ``lighting`` (the sun's shared PCF, deferred lighting),
``skyview_lut`` (the transmittance and sky-view LUTs), ``aerial_lut``
(t_seg rows, the aerial LUT, the f16 sampling copies), ``aerial_exact``
(with ``aerial_lut=False``: the sky pass's per-pixel rays and materials,
the per-pixel in-scattering integrals and the f16 sampling copy), ``sky_pass``
(the sky camera pass) and ``encode`` (debug lines, box filter, OETF,
crop). A frame runs one of ``aerial_lut`` and ``aerial_exact``: eight
layers, a LUT frame never entering ``aerial_exact``; a frame without
the atmosphere runs no sky layer.

Inside ``shadow`` and ``gbuffer`` run the parts of :data:`PARTS`: the
rasters' triangle setup, tile binning and raster (in ``shadow`` summed
over the map slots, the copy of each map into its slot counted as its
raster) and the G-buffer resolve. The layer's time outside its parts is
its rest (the maps' zeroing, the light-space matrices, the corner
gather). Each raster's tile lists also count into the two device
counters of :data:`COUNTERS` (:func:`tally`): the lists that overflowed
into full iteration and the pairs the lists hold.

:func:`layer` opens a ``torch.profiler.record_function`` range named
``syzygy.<layer>`` around each, so an eager frame run under the profiler
shows its layers (a replay runs no Python and shows none), and marks the
layer's start to the recorder that :func:`recording` installs on the
thread, if any; :func:`part` does the same for a part (``syzygy.<layer>.<part>``).
``renderer/frame.py`` installs a
:class:`FrameTrace` only while it captures a frame as a CUDA graph: its
marks become stamps in the graph (``kernels/stamp.py``), so every replay
writes its layers' device times into a ring, and nothing else stamps.
A part's boundaries are stamps too, each into a column of its own after
the layer marks (a part opened where the last one closed, with nothing
enqueued between, shares that stamp); the stamp that closes a binning's
part also copies its tile lists' counters. The host sums each part's
intervals and each counter's columns by name.

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

LAYERS = (
    "state", "shadow", "gbuffer", "lighting", "skyview_lut", "aerial_lut", "aerial_exact", "sky_pass", "encode",
)
MARKS = len(LAYERS) + 1  # a frame's layer boundaries, at most
PARTS = (
    "shadow.setup", "shadow.bin", "shadow.raster", "gbuffer.setup", "gbuffer.bin", "gbuffer.raster", "gbuffer.resolve",
)
COUNTERS = ("raster_overflows", "raster_pairs")
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
def part(name: str):
    """Part ``name`` (``<layer>.<part>``, one of :data:`PARTS`) of the open
    layer runs inside."""
    with torch.profiler.record_function(f"syzygy.{name}"):
        recorder = getattr(_local, "recorder", None)
        if recorder is not None:
            recorder.open_part(name)
        yield
        if recorder is not None:
            recorder.close_part()


def tally(lists) -> None:
    """Count a raster's tile lists (``kernels.raster.TileLists``) into the
    frame's counters: 1 in ``raster_overflows`` where they overflowed, their
    pairs (``offsets[-1]``) in ``raster_pairs``. Inside a part; the stamp
    that closes it copies them on the device."""
    recorder = getattr(_local, "recorder", None)
    if recorder is not None:
        recorder.tally(lists.overflow, lists.offsets[-1:])


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
    (name, start, end) on the device's clock (ns), its host spans
    ``stage`` and ``replay`` (start, end) on the host's clock (s), its
    parts' summed device times (name, ns) and its counters (name, value)."""

    seq: int
    layers: tuple
    stage: tuple
    replay: tuple
    parts: tuple = ()
    counts: tuple = ()

    @property
    def layer_ms(self) -> dict:
        return {name: (end - start) / 1e6 for name, start, end in self.layers}

    @property
    def parts_ms(self) -> dict:
        return {name: ns / 1e6 for name, ns in self.parts}

    @property
    def counters(self) -> dict:
        return dict(self.counts)

    @property
    def stage_ms(self) -> float:
        return (self.stage[1] - self.stage[0]) * 1e3

    @property
    def replay_ms(self) -> float:
        return (self.replay[1] - self.replay[0]) * 1e3


def finished_replays(ring: np.ndarray, layers, host: np.ndarray, replays: int, parts=(), counters=()) -> list:
    """The :class:`Replay` of each of the last ``replays`` replays (at most
    a ring's rows) whose stamps are all written, oldest first. ``ring``:
    the device ring ((rows, columns) int64: ``layers``' marks from column
    0, the last column each slot's sequence number); ``parts``: (name,
    start column, end column) of each part's interval, summed by name;
    ``counters``: (name, column), summed by name; ``host``: (rows, 5)
    float64, each slot's sequence number and stage and replay spans. A
    slot holds replay ``s`` only where both hold ``s``: a slot still being
    written holds -1, one not yet reached an older replay's number."""
    rows = ring.shape[0]
    out = []
    for s in range(max(0, replays - rows), replays):
        dev, h = ring[s % rows], host[s % rows]
        if dev[-1] != s or h[0] != s:
            continue
        spans = tuple((name, int(dev[i]), int(dev[i + 1])) for i, name in enumerate(layers))
        sums, counts = {}, {}
        for name, start, end in parts:
            sums[name] = sums.get(name, 0) + int(dev[end] - dev[start])
        for name, column in counters:
            counts[name] = counts.get(name, 0) + int(dev[column])
        stage, replay = (float(h[1]), float(h[2])), (float(h[3]), float(h[4]))
        out.append(Replay(s, spans, stage, replay, tuple(sums.items()), tuple(counts.items())))
    return out


class FrameTrace:
    """The layer marks of one captured frame and the records of its
    replays, in rings of :data:`RING_REPLAYS` replays: on ``device``, the stamps
    (``ring``: column j mark j's time, then the columns of the parts'
    stamps and counters of a frame with ``shadow_slots`` map slots, the
    last column the sequence number; ``seq`` the replays finished); on the
    host, each replay's sequence number and ``stage`` and ``replay``
    spans, and the columns of the frame's ``spans`` (part, start, end) and
    ``counter_columns`` (counter, column).
    ``parts`` and ``counters`` name those the frame wrote. While the frame
    is captured on a CUDA device, each mark also reads the graph's node
    count, so ``nodes`` holds each layer's nodes (its stamp left out, its
    part stamps in), ``stamps``, ``part_stamps`` and the graph's
    ``total``."""

    def __init__(self, device, shadow_slots: int = 10):
        # a stamp at each part boundary (three parts a slot and four in
        # gbuffer, each run of parts sharing its inner boundaries) and
        # each raster's two counters
        columns = (3 * shadow_slots + 1) + 5 + 2 * (shadow_slots + 1)
        self.ring = torch.full((RING_REPLAYS, MARKS + columns + 1), -1, dtype=torch.int64, device=device)
        self.seq = torch.zeros((), dtype=torch.int64, device=device)
        self.host = np.full((RING_REPLAYS, 5), -1.0)
        self.replays = 0  # replays enqueued
        self.layers: list = []
        self.spans: list = []
        self.counter_columns: list = []
        self.nodes: dict | None = None
        self._marks = 0
        self._counts: list = []  # graph nodes before each stamp
        self._part_stamps = 0
        self._column = MARKS  # the next free column
        self._open = None  # (part, start column) inside which the frame runs
        self._boundary = None  # (column, graph nodes) of the stamp that closed the layer's last part
        self._tally = None  # (overflow, pairs) for the open part's closing stamp

    @property
    def parts(self) -> list:
        return list(dict.fromkeys(name for name, _, _ in self.spans))

    @property
    def counters(self) -> list:
        return list(dict.fromkeys(name for name, _ in self.counter_columns))

    def begin(self) -> None:
        self._mark(last=False)

    def enter(self, name: str) -> None:
        if self.layers and self.layers[-1] == name:
            return
        if name in self.layers or name not in LAYERS or self._open is not None:
            raise ValueError(f"layer {name!r} out of place after {self.layers}")
        self._boundary = None
        if self.layers:
            self._mark(last=False)
        self.layers.append(name)

    def end(self) -> None:
        if self._open is not None:
            raise ValueError(f"the frame ended inside part {self._open[0]!r}")
        self._mark(last=True)
        if self._counts:
            total = self._nodes()
            counts = self._counts + [total]
            self.nodes = {name: counts[i + 1] - counts[i] - 1 for i, name in enumerate(self.layers)}
            self.nodes.update(stamps=self._marks, part_stamps=self._part_stamps, total=total)

    def open_part(self, name: str) -> None:
        if name not in PARTS or not self.layers or name.split(".")[0] != self.layers[-1] or self._open is not None:
            raise ValueError(f"part {name!r} out of place in layer {self.layers[-1:]}, part {self._open!r} open")
        if self._boundary is not None and self._boundary[1] == self._nodes():
            self._open = (name, self._boundary[0])
        else:
            self._open = (name, self._part_mark())

    def close_part(self) -> None:
        (name, start), tally = self._open, self._tally
        end = self._part_mark(tally)
        self.spans.append((name, start, end))
        if tally is not None:
            self.counter_columns += [(COUNTERS[0], end + 1), (COUNTERS[1], end + 2)]
        self._boundary = (end, self._nodes())
        self._open = self._tally = None

    def tally(self, overflow: torch.Tensor, pairs: torch.Tensor) -> None:
        if self._open is None or self._tally is not None:
            raise ValueError("a tally belongs inside a part, one a part")
        self._tally = (overflow, pairs)

    def _part_mark(self, tally=None) -> int:
        column = self._column
        self._column += 1 if tally is None else 3
        stamps.stamp(self.ring, self.seq, column, False, *(tally or (None, None)), kind="part")
        self._part_stamps += 1
        return column

    def _nodes(self):
        return stamps.capture_nodes(self.ring.device) if self.ring.device.type == "cuda" else None

    def _mark(self, last: bool) -> None:
        count = self._nodes()
        if count is not None:
            self._counts.append(count)
        stamps.stamp(self.ring, self.seq, self._marks, last)
        self._marks += 1

    def replayed(self, stage: tuple, replay: tuple) -> None:
        """Record the host spans of the replay just enqueued."""
        self.host[self.replays % self.host.shape[0]] = (self.replays, *stage, *replay)
        self.replays += 1

    def read(self) -> list:
        """The finished replays (:func:`finished_replays`). Copies the
        device ring to the host: read after the frames are done."""
        return finished_replays(
            self.ring.cpu().numpy(), self.layers, self.host, self.replays, self.spans, self.counter_columns
        )
