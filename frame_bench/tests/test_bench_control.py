"""The control comes out not correct: the program with its own
lower-precision LUT storage switched on (``lut_f16``: f16 sampling copies
of the transmittance LUT and the aerial volume, where the configurations
state f32), the step a later change would be tempted to take.

On the card (``cuda``) at each cell's own size, as the limits were set;
on the CPU at 256x128, where the control's readings are of the same
order."""

import time

import pytest
import torch
from conftest import CELLS, SEED, small_cell

from frame_bench.check import check_run
from frame_bench.harness import load_cell, run_cell


def _control(cell, device, seconds):
    run = run_cell(cell, SEED, seconds, False, device, time.perf_counter(), render_overrides={"lut_f16": True})
    correct, checks, readings, _ = check_run(run, device)
    return correct, checks, readings


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_256x128(name):
    cell = small_cell(name)
    cell.traffic = {**cell.traffic, "check_frames": 1}
    correct, checks, _ = _control(cell, torch.device("cpu"), 0.1)
    assert correct is False
    assert checks["rmse"]["value"] > checks["rmse"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(cuda, name):
    from syzygy_tpu_torch.renderer import frame

    try:
        correct, checks, readings = _control(load_cell(name), cuda, 3.0)
    finally:
        frame._GRAPHS.clear()
    assert len(readings) == 3
    assert correct is False
    assert all(r["rmse"] > checks["rmse"]["limit"] for r in readings.values())
