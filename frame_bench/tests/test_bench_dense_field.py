"""The ``dense-field`` cell at 256x128 on the CPU, its field cut to 4
spheres of 8 rings x 16 segments: the run matches the plain reference
bitwise, and the seven readers of the rasters' parts and counters read
the port's records of them, here kept by a recorder around each CPU
frame as the CUDA graph keeps them around each replay; a program that
keeps no parts or counters (the port before them) gives None."""

import time
from typing import NamedTuple

import pytest
import torch
from conftest import SEED, small_cell

from frame_bench.check import check_run
from frame_bench.harness import port_api, run_cell
from frame_bench.run import read_metrics
from frame_bench.scenes import dense_field

CELL = "dense-field.batch-sunanim"
METRICS = (
    "raster_setup_dev_ms", "raster_bin_dev_ms", "raster_kernel_dev_ms", "gbuffer_resolve_dev_ms",
    "raster_overflows", "raster_pairs", "raster_kernel_roofline",
)


class Recorded:
    """The port's frame entry with each call after the first (the
    set-up's eager frame, where the card captures its graph) recorded
    into one CPU :class:`FrameTrace`'s ring, as each replay is on the
    card: each frame marks on a recorder of its own that writes that
    ring."""

    def __init__(self):
        from syzygy_tpu_torch.renderer.layers import FrameTrace

        self.trace = FrameTrace("cpu")
        self.calls = 0

    def __call__(self, geometry, row, spec, config):
        from syzygy_tpu_torch.renderer.layers import FrameTrace, recording

        render = port_api().render_frame_packed
        self.calls += 1
        if self.calls == 1:
            return render(geometry, row, spec, config)
        frame = FrameTrace("cpu")
        frame.ring, frame.seq = self.trace.ring, self.trace.seq
        t0 = time.perf_counter()
        with recording(frame):
            image = render(geometry, row, spec, config)
        self.trace.replayed((t0, t0), (t0, time.perf_counter()))
        self.trace.layers, self.trace.spans = frame.layers, frame.spans
        self.trace.counter_columns = frame.counter_columns
        return image

    def graph(self, read=None) -> dict:
        return {"config": None, "capture_s": 0.0, "pool_bytes": 0, "launches": {}, "layers": self.trace.layers,
                "nodes": None, "replays": self.trace.replays, "read": read or self.trace.read}


class ParentReplay(NamedTuple):
    """A replay record of the port before the parts: no parts, no counters."""

    seq: int
    layers: tuple
    stage: tuple
    replay: tuple

    @property
    def layer_ms(self) -> dict:
        return {name: (end - start) / 1e6 for name, start, end in self.layers}


@pytest.fixture(scope="module")
def recorded_run():
    patch = pytest.MonkeyPatch()
    small = dense_field.inputs
    patch.setattr(dense_field, "inputs", lambda: small(rings=8, segments=16, side=2))
    try:
        cell = small_cell(CELL)
        render = Recorded()
        run = run_cell(cell, SEED, 6.0, False, torch.device("cpu"), time.perf_counter(), render=render)
        correct, checks, _, _ = check_run(run, torch.device("cpu"))
        run.graph = render.graph()
        yield run, render, correct, checks, read_metrics(run, cell.per_layer)
    finally:
        patch.undo()


def test_dense_cell_matches_the_reference_and_reads_its_parts(recorded_run):
    run, _, correct, checks, metrics = recorded_run
    assert correct is True and checks["rmse"]["value"] == 0.0
    assert [m["name"] for m in run.cell.per_layer] == list(METRICS)
    assert set(metrics) == set(METRICS)
    values = {name: m["value"] for name, m in metrics.items()}
    assert all(values[name] > 0.0 for name in METRICS if name != "raster_overflows")
    assert values["raster_overflows"] == 0.0  # capacity 448 holds every list of the small field
    assert 0.0 < values["raster_kernel_roofline"] < 100.0


def test_a_program_without_parts_gives_none(recorded_run):
    run, render, *_ = recorded_run
    parent = [ParentReplay(r.seq, r.layers, r.stage, r.replay) for r in render.trace.read()]
    stripped = [r._replace(parts=(), counts=()) for r in render.trace.read()]
    for read in (lambda: parent, lambda: stripped):
        run.graph = render.graph(read)
        assert read_metrics(run, run.cell.per_layer) == {}
    run.graph = None  # no graph at all
    assert read_metrics(run, run.cell.per_layer) == {}
    run.graph = render.graph()
