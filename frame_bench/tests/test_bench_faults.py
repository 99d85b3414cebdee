"""A run with its timed path broken underneath comes out not correct:
each fault a frame of these cells can have, planted in the port's frame
entry, at 256x128 on the CPU. (One chip and one frame per call: there is
no exchange between chips and no batch.)"""

import time

import pytest
import torch
from conftest import CELLS, SEED, small_cell

from frame_bench.harness import port_api
from frame_bench.run import result_line


def _stale(render):
    """Returns the previous call's image: the state never moves on."""
    last = []

    def broken(*args):
        image = render(*args)
        out = last[0] if last else image
        last[:] = [image]
        return out

    return broken


def _half_rows(render):
    """Leaves out the lower half of the image's rows."""

    def broken(*args):
        image = render(*args).clone()
        image[image.shape[0] // 2 :] = 0.0
        return image

    return broken


def _altered(render):
    """Alters a 16x16 block of the image where it is produced."""

    def broken(*args):
        image = render(*args).clone()
        image[40:56, 100:116] = 1.0 - image[40:56, 100:116]
        return image

    return broken


@pytest.mark.parametrize("fault", [_stale, _half_rows, _altered], ids=["stale", "half_rows", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_frame_is_not_correct(name, fault):
    cell = small_cell(name)
    cell.traffic = {**cell.traffic, "check_frames": 2}
    broken = fault(port_api().render_frame_packed)
    result = result_line(cell, SEED, 0.1, False, torch.device("cpu"), time.perf_counter(), render=broken)
    assert result["correct"] is False
    assert result["failed"] >= 1
