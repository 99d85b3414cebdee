"""The quirk-exact configuration and the turntable cells at 256x128 on the
CPU: both new cells run through ``result_line`` and match the plain
reference bitwise; the program's own approximations of the quirk-exact
sky (the aerial LUT, ``fast_sky``, ``fast_sky_reflection``, ``lut_f16``)
fail the quirk-exact cell's limits; the ``aerial_exact`` readers read
the port's records of that layer and give None on a run without it."""

import json
import time
import types
from typing import NamedTuple

import pytest
import torch
from conftest import SEED, small_cell

from frame_bench.check import check_run, reference_frames
from frame_bench.harness import Frame, Run, Spans, run_cell
from frame_bench.metrics import aerial_exact_dev_ms, aerial_exact_nodes, aerial_exact_roofline
from frame_bench.run import result_line

EXACT = "chess-gltf-quirk-exact.batch-turntable"
CELLS = ("chess-gltf.batch-turntable", EXACT)
CONTROLS = {
    "aerial_lut": {"aerial_lut": True},
    "fast_sky": {"fast_sky": True},
    "fast_sky_reflection": {"fast_sky_reflection": True},
    "lut_f16": {"lut_f16": True},
}


@pytest.mark.parametrize("name", CELLS)
def test_turntable_cell_runs_and_matches_the_reference(name):
    cell = small_cell(name)
    result = result_line(cell, SEED, 4.0, False, torch.device("cpu"), time.perf_counter())
    json.dumps(result)
    assert result["correct"] is True and result["failed"] == 0
    assert "setup_s" in result["metrics"]  # frame_ms only once a CPU frame lands inside the short window
    assert result["check"]["frames"]["value"] >= 1
    assert result["check"]["rmse"]["value"] == 0.0  # the port's CPU frame is the reference's, bitwise


def test_quirk_exact_cell_states_upstreams_integrals():
    render = small_cell(EXACT).config["render"]
    assert (render["aerial_lut"], render["fast_sky"], render["fast_sky_reflection"]) == (False, False, False)
    assert render["metallic_reflection"] is True


@pytest.mark.parametrize("control", list(CONTROLS))
def test_control_fails_the_quirk_exact_limits_at_256x128(control):
    cell = small_cell(EXACT)
    cell.traffic = {**cell.traffic, "check_frames": 1}
    run = run_cell(cell, SEED, 0.1, False, torch.device("cpu"), time.perf_counter(),
                   render_overrides=CONTROLS[control])
    correct, checks, _, _ = check_run(run, torch.device("cpu"))
    assert correct is False
    assert any(checks[n]["value"] > checks[n]["limit"] for n in cell.limits)


class Replay(NamedTuple):
    """What the readers use of the port's replay record."""

    seq: int
    layer_ms: dict


def _run(cell, layers, nodes, kept=()):
    """A made-up run of four counted frames (replays 1-4; replay 0 the
    set-up's), layer j of replay s taking (j + 1) x (s + 1) ms."""
    frames = [Frame(k, float(k), float(k) + 0.2, counted=True) for k in range(1, 5)]
    records = [Replay(s, {name: (j + 1.0) * (s + 1) for j, name in enumerate(layers)}) for s in range(5)]
    graph = {"config": None, "layers": list(layers), "nodes": nodes, "replays": 5, "read": lambda: records}
    run = Run(cell, SEED, 1.0, 1.0, frames, Spans(), None, graph)
    run.kept = {k: None for k in kept}
    return run


LUT_LAYERS = ("state", "shadow", "gbuffer", "lighting", "skyview_lut", "aerial_lut", "sky_pass", "encode")
EXACT_LAYERS = ("state", "shadow", "gbuffer", "lighting", "skyview_lut", "aerial_exact", "sky_pass", "encode")


def test_readers_give_none_without_the_layer():
    cell = small_cell(EXACT)
    lut = _run(cell, LUT_LAYERS, {"state": 10, "stamps": 9, "total": 500}, kept=(1,))
    readers = (aerial_exact_dev_ms, aerial_exact_nodes, aerial_exact_roofline)
    assert [r.read(lut) for r in readers] == [None, None, None]  # a LUT frame, or the parent's quirk-exact frame
    lut.graph = None  # no graph at all (a CPU run)
    assert [r.read(lut) for r in readers] == [None, None, None]


def test_readers_read_the_layer_and_the_kept_frames():
    cell = small_cell(EXACT)
    run = _run(cell, EXACT_LAYERS, {"aerial_exact": 1234, "stamps": 9, "total": 5000}, kept=(1, 3))
    run.trace = types.SimpleNamespace(profiled=[4])  # frames 1-3 before the profiler: replays 1-3
    dev_ms = 6.0 * (2 + 3 + 4) / 3
    assert aerial_exact_dev_ms.read(run) == pytest.approx(dev_ms)
    assert aerial_exact_nodes.read(run) == 1234.0
    from frame_bench.aerial_work import aerial_work

    least = [aerial_work(g, p, c).least_s for _, g, p, c in reference_frames(cell, SEED, torch.device("cpu"), (1, 3))]
    assert all(s > 0 for s in least)
    assert aerial_exact_roofline.read(run) == pytest.approx(100.0 * (sum(least) / 2) / (dev_ms / 1e3))
