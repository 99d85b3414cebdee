"""The frame's layers traced from inside (``renderer/layers.py``).

On the CPU, with a :class:`FrameTrace` installed as the recorder (its
stamps the host clock's, ``kernels/stamp.py::stamp_plain``): a 256x128
frame marks its eight layers in frame order, the frames without the
atmosphere or with the quirk-exact sky (``aerial_exact`` in place of
``aerial_lut``) mark theirs, the image is bitwise the
frame without a recorder, a profiled frame shows a ``syzygy.<layer>``
range per layer it runs and a ``syzygy.<layer>.<part>`` range per part,
host stamps count no kernel launch, and the
ring's reader keeps only the slots whose
sequence number matches (wrap-around, half-written and stale slots on a
made-up ring) and sums the parts' intervals and the counters' columns
by name beside the layers'; the plain stamp copies a raster's tile-list
counters after its mark; parts share a boundary stamp only where
nothing is enqueued between them.

The ``cuda``-marked tests run the stamps captured into the CUDA graph;
they skip without a GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_trace.py
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from syzygy_tpu_torch.renderer import layers
from syzygy_tpu_torch.renderer.layers import LAYERS, MARKS, PARTS, FrameTrace, finished_replays, layer, recording

SMALL = dict(width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64)
LUT_LAYERS = [name for name in LAYERS if name != "aerial_exact"]  # a frame of the default aerial LUT
EXACT_LAYERS = [name for name in LAYERS if name != "aerial_lut"]  # a quirk-exact frame


def _frame_inputs(device, **overrides):
    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, lib = default_scene()
    scene.tick(0.0)
    config = RenderConfig(**(SMALL | overrides))
    host = pack_frame_params(scene, config.width / config.height)
    spec = frame_param_spec(host)
    return pack_geometry(scene, lib, device), host, spec, flatten_frame_params(host, spec), config


@pytest.fixture(scope="module")
def small_ring():
    """Rings of 4 replays for this module's CPU recorders."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(layers, "RING_REPLAYS", 4)
        yield


@pytest.fixture(scope="module")
def cpu_frame():
    """The 256x128 CPU frame's inputs and its image without a recorder."""
    from syzygy_tpu_torch.renderer.frame import render_frame_eager
    from syzygy_tpu_torch.scene.pack import upload_frame_params

    geometry, host, _, _, config = _frame_inputs("cpu")
    params = upload_frame_params(host, "cpu")
    return geometry, params, config, render_frame_eager(geometry, params, config)


def _recorded(cpu_frame, **overrides):
    from syzygy_tpu_torch.renderer.frame import render_frame_eager

    geometry, params, config, _ = cpu_frame
    trace = FrameTrace("cpu")
    with recording(trace):
        image = render_frame_eager(geometry, params, dataclasses.replace(config, **overrides))
    return trace, image


@pytest.fixture(scope="module")
def recorded(cpu_frame, small_ring):
    return _recorded(cpu_frame)


def test_frame_marks_every_layer_in_order(recorded):
    trace, _ = recorded
    assert trace.ring.shape[0] == 4
    assert trace.layers == LUT_LAYERS
    # the ten slots' and the camera's parts fill the columns between the
    # layer marks and the sequence number, each once
    used = [c for _, a, b in trace.spans for c in (a, b)] + [c for _, c in trace.counter_columns]
    assert sorted(set(used)) == list(range(MARKS, trace.ring.shape[1] - 1))
    assert len(trace.spans) == 3 * 10 + 4 and len(trace.counter_columns) == 2 * 11
    slot = trace.ring[0].tolist()
    assert slot[-1] == 0 and int(trace.seq) == 1  # the last mark finished replay 0
    times = slot[: len(LUT_LAYERS) + 1]
    assert times == sorted(times) and min(times) > 0
    assert trace.nodes is None  # no graph on the CPU


def test_recorder_leaves_the_frame_bitwise(cpu_frame, recorded):
    _, image = recorded
    assert torch.equal(image.view(torch.int32), cpu_frame[3].view(torch.int32))


@pytest.mark.parametrize(
    "overrides, marked",
    [
        ({"render_atmosphere": False}, ["state", "shadow", "gbuffer", "lighting", "encode"]),
        ({"aerial_lut": False, "lut_f16": True}, EXACT_LAYERS),
        ({"aerial_lut": False, "fast_sky_reflection": False}, EXACT_LAYERS),
    ],
    ids=["no_atmosphere", "no_aerial_lut", "quirk_exact"],
)
def test_frames_without_a_layer_mark_the_rest(cpu_frame, small_ring, overrides, marked):
    trace, _ = _recorded(cpu_frame, **overrides)
    assert trace.layers == marked
    trace.replayed((1.0, 1.25), (1.25, 1.5))
    (replay,) = trace.read()
    assert [name for name, _, _ in replay.layers] == marked
    assert all(start <= end for _, start, end in replay.layers)
    assert replay.stage_ms == pytest.approx(250.0) and replay.replay_ms == pytest.approx(250.0)


def test_profiled_frame_shows_each_layer(cpu_frame):
    """Without a recorder too (the frame without the atmosphere: the
    profiler slows a CPU frame's many small operations)."""
    from torch.profiler import ProfilerActivity, profile

    from syzygy_tpu_torch.renderer.frame import render_frame_eager

    geometry, params, config, _ = cpu_frame
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_frame_eager(geometry, params, dataclasses.replace(config, render_atmosphere=False))
    names = {e.key for e in prof.key_averages() if e.key.startswith("syzygy.")}
    assert names == {f"syzygy.{name}" for name in ("state", "shadow", "gbuffer", "lighting", "encode") + PARTS}


def test_layers_out_of_place_and_nested_recordings_refuse(small_ring):
    trace = FrameTrace("cpu")
    with pytest.raises(ValueError, match="out of place"):
        with recording(trace):
            with layer("state"):
                pass
            with layer("shadow"):
                pass
            with layer("state"):
                pass
    with pytest.raises(RuntimeError, match="already"):
        with recording(FrameTrace("cpu")):
            with recording(FrameTrace("cpu")):
                pass
    with layer("state"):  # no recorder left installed
        assert getattr(layers._local, "recorder", None) is None


def test_stamps_on_the_cpu_count_no_launch(small_ring):
    from syzygy_tpu_torch.kernels.build import LAUNCHES

    trace = FrameTrace("cpu")
    before = LAUNCHES["stamp"]
    with recording(trace):
        with layer("state"):
            pass
    trace.replayed((0.0, 0.0), (0.0, 0.0))  # no graph: nothing launched
    assert LAUNCHES["stamp"] == before and trace.replays == 1 and trace.nodes is None


class _FakeLibrary:
    """Stands in for a built kernel library: records each call of an entry
    point and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or self.err


@pytest.mark.parametrize("err", [0, 700])
def test_launch_counts_by_kind_and_by_capture(monkeypatch, err):
    """``kernels.build.launch`` passes the device index and the current
    raw stream after the arguments and raises on a CUDA error, naming the
    entry point. A launch outside a capture counts into ``LAUNCHES``; one
    captured inside ``capture_record`` into that record alone; one
    captured outside a record nowhere. Records do not nest."""
    from syzygy_tpu_torch.kernels import build

    library = _FakeLibrary(err)
    capturing = [False]
    monkeypatch.setattr(build, "load", lambda name: library)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(build, "LAUNCHES", type(build.LAUNCHES)())
    device = torch.device("cuda", 3)
    if err:
        with pytest.raises(RuntimeError, match="szg_lighting failed: CUDA error 700"):
            build.launch("szg_lighting", device, 1, 2, counts={"lighting": 1})
        assert not build.LAUNCHES
        return
    build.launch("szg_scattering", device, 5, counts={"scattering": 1, "scattering_rays": 64})
    assert library.calls == [("szg_scattering", (5, 3, 1003))]
    capturing[0] = True
    with build.capture_record() as record:
        build.launch("szg_stamp", device, counts={"stamp": 1})
        build.launch("szg_stamp", device, counts={"stamp": 1})
        with pytest.raises(RuntimeError):
            with build.capture_record():
                pass
    build.launch("szg_lane_gather", device, counts={"lane_gather": 1})  # captured, no record open
    assert record == {"stamp": 2}
    assert build.LAUNCHES == {"scattering": 1, "scattering_rays": 64}
    capturing[0] = False
    build.LAUNCHES.update(record)  # what a replay adds
    assert build.LAUNCHES == {"scattering": 1, "scattering_rays": 64, "stamp": 2}


def _made_up_ring(rows, replays, layer_names):
    """The rings as ``replays`` replays leave them: replay s in slot
    s % rows, its marks at 1000 s + 10 j ns, its host spans at s + 0.1."""
    n = len(layer_names) + 1
    ring = np.full((rows, MARKS + 1), -1, np.int64)
    host = np.full((rows, 5), -1.0)
    for s in range(replays):
        ring[s % rows, :n] = 1000 * s + 10 * np.arange(n)
        ring[s % rows, -1] = s
        host[s % rows] = (s, s, s + 0.1, s + 0.1, s + 0.3)
    return ring, host


def test_reader_keeps_finished_slots_across_wrap_around():
    names = ["state", "shadow", "encode"]
    ring, host = _made_up_ring(4, 10, names)
    got = finished_replays(ring, names, host, 10)
    assert [r.seq for r in got] == [6, 7, 8, 9]  # the ring keeps the last 4
    assert got[0].layers == (("state", 6000, 6010), ("shadow", 6010, 6020), ("encode", 6020, 6030))
    assert got[0].layer_ms == {"state": 1e-5, "shadow": 1e-5, "encode": 1e-5}
    assert got[-1].stage_ms == pytest.approx(100.0) and got[-1].replay_ms == pytest.approx(200.0)
    assert [r.seq for r in finished_replays(ring, names, host, 3)] == []  # every slot holds a later replay


def test_reader_skips_half_written_and_stale_slots():
    names = ["state", "encode"]
    ring, host = _made_up_ring(4, 6, names)
    ring[5 % 4, -1] = -1  # replay 5: its first mark ran, its last not yet
    assert [r.seq for r in finished_replays(ring, names, host, 6)] == [2, 3, 4]
    ring, host = _made_up_ring(4, 6, names)
    ring[4 % 4, -1] = 0  # replay 4 never reached its slot: the device wrote replay 0 there
    host[3 % 4, 0] = 7  # a host record of another replay
    assert [r.seq for r in finished_replays(ring, names, host, 6)] == [2, 5]


def test_reader_parses_parts_and_counters_beside_the_layers():
    """A ring with part marks and counters after the layer marks: each
    replay's ``parts_ms`` sums the intervals of each part (a part entered
    twice, two parts sharing a boundary) and ``counters`` each counter's
    columns, and the eight layers' ``layer_ms`` are those of the same ring
    without them."""
    rows, replays = 4, 6
    ring, host = _made_up_ring(rows, replays, LUT_LAYERS)
    wide = np.full((rows, MARKS + 11), -1, np.int64)
    wide[:, :MARKS] = ring[:, :MARKS]
    wide[:, -1] = ring[:, -1]
    spans = [("shadow.setup", MARKS, MARKS + 1), ("shadow.bin", MARKS + 1, MARKS + 2),
             ("shadow.setup", MARKS + 2, MARKS + 5), ("gbuffer.resolve", MARKS + 6, MARKS + 7)]
    # the stamps at MARKS + 2 and MARKS + 7 copied a raster's counters after them
    counters = [("raster_overflows", MARKS + 3), ("raster_pairs", MARKS + 4),
                ("raster_overflows", MARKS + 8), ("raster_pairs", MARKS + 9)]
    for s in range(replays):
        times = 1_000_000 * s + np.array([0, 1000, 3000, 7000, 8000, 8500])
        wide[s % rows, MARKS: MARKS + 10] = [*times[:3], s % 2, 100 + s, *times[3:], 1, 9000 + s]
    plain = finished_replays(ring, LUT_LAYERS, host, replays)
    got = finished_replays(wide, LUT_LAYERS, host, replays, spans, counters)
    assert [r.seq for r in got] == [r.seq for r in plain] == [2, 3, 4, 5]
    for r, p in zip(got, plain):
        assert r.layer_ms == p.layer_ms and len(r.layer_ms) == 8
        assert r.parts_ms == {"shadow.setup": (1000 + 4000) / 1e6, "shadow.bin": 2000 / 1e6,
                              "gbuffer.resolve": 500 / 1e6}
        assert r.counters == {"raster_overflows": r.seq % 2 + 1, "raster_pairs": 100 + r.seq + 9000 + r.seq}
        assert p.parts_ms == {} and p.counters == {}
    parts_only = finished_replays(wide, LUT_LAYERS, host, replays, spans[3:])
    assert list(parts_only[0].parts_ms) == ["gbuffer.resolve"] and parts_only[0].counters == {}


def test_plain_stamp_copies_a_rasters_counters_after_its_mark():
    """``stamp_plain`` with a tile list's ``overflow`` and ``pairs``: the
    time in the mark's column, the flag and the pairs in the two after it,
    no other cell written; a stamp refuses one counter without the other,
    counters of another type and counters past the sequence column."""
    from syzygy_tpu_torch.kernels import stamp as st

    ring = torch.full((2, 8), 7, dtype=torch.int64)
    seq = torch.tensor(3, dtype=torch.int64)
    st.stamp(ring, seq, 2, False, torch.tensor(True), torch.tensor([40], dtype=torch.int32), kind="part")
    st.stamp(ring, seq, 5, False)
    slot = ring[1]
    assert slot[2] > 7 and slot[5] > 7 and slot[3:5].tolist() == [1, 40]
    assert slot[[0, 1, 6, 7]].tolist() == [7] * 4 and bool((ring[0] == 7).all()) and int(seq) == 3
    st.stamp(ring, seq, 4, False, torch.tensor(False), torch.tensor([0], dtype=torch.int32))
    assert slot[5:7].tolist() == [0, 0]
    with pytest.raises(ValueError, match="both"):
        st.stamp(ring, seq, 2, False, torch.tensor(True), None)
    with pytest.raises(ValueError, match="counter"):
        st.stamp(ring, seq, 2, False, torch.tensor(1), torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        st.stamp(ring, seq, 5, False, torch.tensor(True), torch.tensor([4], dtype=torch.int32))


def test_parts_share_a_stamp_only_where_nothing_runs_between(small_ring, monkeypatch):
    """A part opened where the last one closed shares its stamp while the
    graph's node count stands still; where work was enqueued between (a
    node count that grows) it takes a stamp of its own, so that work
    counts in no part. A part outside its layer and a tally outside a part
    refuse."""
    from syzygy_tpu_torch.renderer.layers import part, tally

    def spans(nodes):
        trace = FrameTrace("cpu")
        monkeypatch.setattr(trace, "_nodes", lambda: next(nodes))
        with recording(trace):
            with layer("state"):
                pass
            with layer("shadow"):
                for name in ("shadow.setup", "shadow.bin", "shadow.raster", "shadow.setup"):
                    with part(name):
                        pass
        return trace.spans, trace.nodes

    still, _ = spans(iter([1] * 100))
    assert still == [("shadow.setup", MARKS, MARKS + 1), ("shadow.bin", MARKS + 1, MARKS + 2),
                     ("shadow.raster", MARKS + 2, MARKS + 3), ("shadow.setup", MARKS + 3, MARKS + 4)]
    growing, nodes = spans(iter(range(100)))
    assert growing == [(name, MARKS + 2 * i, MARKS + 2 * i + 1) for i, (name, _, _) in enumerate(still)]
    assert nodes["part_stamps"] == 8 and nodes["stamps"] == 3
    with pytest.raises(ValueError, match="out of place"):
        with recording(FrameTrace("cpu")):
            with layer("state"):
                with part("shadow.setup"):
                    pass
    lists = types.SimpleNamespace(overflow=torch.tensor(False), offsets=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="inside a part"):
        with recording(FrameTrace("cpu")):
            with layer("gbuffer"):
                tally(lists)
    tally(lists)  # no recorder: nothing to count


# --------------------------------------------------------------------------
# on the card: the stamps in the CUDA graph
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the stamps are captured into a CUDA graph)")
    return torch.device("cuda", 0)


def _graph():
    from syzygy_tpu_torch.renderer.frame import captured_frames

    return captured_frames()[-1]  # the graph used last


@pytest.mark.cuda
def test_replay_carries_every_stamp_and_its_layers_sum_to_its_interval(cuda):
    """A 1080p replay: the LUT frame's eight layers, their sum within 0.5% of the
    replay's interval by CUDA events (the second replay's, so the graph's
    launch is not inside it), and the node counts summing to the total."""
    from syzygy_tpu_torch.kernels.build import LAUNCHES
    from syzygy_tpu_torch.renderer.frame import render_frame_packed

    geometry, _, spec, row, config = _frame_inputs(cuda, width=1920, height=1080, shadow_dim=1024,
                                                   skyview_width=2048, skyview_height=1024)
    before = LAUNCHES["stamp"]
    render_frame_packed(geometry, row, spec, config)  # the eager frame and the capture
    assert LAUNCHES["stamp"] == before  # captured, not launched
    render_frame_packed(geometry, row, spec, config)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    render_frame_packed(geometry, row, spec, config)
    end.record()
    torch.cuda.synchronize()
    graph = _graph()
    assert graph["layers"] == LUT_LAYERS and graph["replays"] == 2
    replays = graph["read"]()
    assert [r.seq for r in replays] == [0, 1]
    replay = replays[1]
    assert [name for name, _, _ in replay.layers] == LUT_LAYERS
    assert all(e >= s for _, s, e in replay.layers)
    interval = start.elapsed_time(end)
    assert abs(sum(replay.layer_ms.values()) - interval) <= 0.005 * interval, (replay.layer_ms, interval)
    assert 0.0 < replay.stage_ms and 0.0 < replay.replay_ms
    nodes = graph["nodes"]
    assert nodes["stamps"] == len(LUT_LAYERS) + 1
    assert sum(nodes[name] for name in LUT_LAYERS) + nodes["stamps"] == nodes["total"]
    assert all(nodes[name] > 0 for name in LUT_LAYERS)
    assert LAUNCHES["stamp"] == before + 2 * (len(LUT_LAYERS) + 1)  # the stamps each replay launched
    assert graph["launches"]["stamp"] == len(LUT_LAYERS) + 1


@pytest.mark.cuda
def test_quirk_exact_replay_stamps_its_integrals_layer(cuda):
    """A quirk-exact 1080p replay: ``aerial_exact`` between
    ``skyview_lut`` and ``sky_pass``, with device time and nodes of its
    own, the layers summing to the graph's nodes, and the replay bitwise
    the eager frame."""
    from syzygy_tpu_torch.renderer.frame import render_frame_eager, render_frame_packed
    from syzygy_tpu_torch.scene.pack import upload_frame_params

    geometry, host, spec, row, config = _frame_inputs(
        cuda, width=1920, height=1080, shadow_dim=1024, skyview_width=2048, skyview_height=1024,
        aerial_lut=False, fast_sky_reflection=False,
    )
    render_frame_packed(geometry, row, spec, config)  # the eager frame and the capture
    image = render_frame_packed(geometry, row, spec, config)
    eager = render_frame_eager(geometry, upload_frame_params(host, cuda), config)
    torch.cuda.synchronize()
    assert torch.equal(image, eager)
    graph = _graph()
    assert graph["layers"] == EXACT_LAYERS
    (replay,) = graph["read"]()
    assert [name for name, _, _ in replay.layers] == EXACT_LAYERS
    assert replay.layer_ms["aerial_exact"] > 0.0
    nodes = graph["nodes"]
    assert nodes["stamps"] == len(EXACT_LAYERS) + 1
    assert sum(nodes[name] for name in EXACT_LAYERS) + nodes["stamps"] == nodes["total"]
    assert nodes["aerial_exact"] > 0


@pytest.mark.cuda
def test_frames_in_flight_read_their_own_slots(cuda, monkeypatch):
    """Five replays enqueued back to back, no wait between them, on a
    ring of two: the last two are read, each from its own slot, in
    order on the device's clock."""
    from syzygy_tpu_torch.renderer.frame import render_frame_packed
    from syzygy_tpu_torch.scene.pack import flatten_frame_params

    monkeypatch.setattr(layers, "RING_REPLAYS", 2)
    geometry, host, spec, row, config = _frame_inputs(cuda, shadow_dim=512)
    render_frame_packed(geometry, row, spec, config)
    torch.cuda.synchronize()
    images = []
    for _ in range(5):  # the same inputs, a new host row each frame
        images.append(render_frame_packed(geometry, flatten_frame_params(host, spec), spec, config))
    torch.cuda.synchronize()
    graph = _graph()
    assert graph["replays"] == 5
    replays = graph["read"]()
    assert [r.seq for r in replays] == [3, 4]
    first, second = replays
    assert first.layers[-1][2] <= second.layers[0][1]
    assert first.replay[1] <= second.stage[0]
    assert all(torch.equal(image, images[0]) for image in images[1:])
