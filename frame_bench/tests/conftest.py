"""Shared pieces of the benchmark's tests: its cells at 256x128 on the
CPU (the render settings cut in both the port and the reference), and the
``cuda`` fixture that skips a card test on a host without one."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from frame_bench.harness import load_cell  # noqa: E402

CELLS = ("editor-default.batch-sunanim", "chess-gltf.interactive-orbit")
SMALL = dict(
    width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64,
    transmittance_width=64, transmittance_height=16,
)
SEED = 2**31 + 4099  # past 32 signed bits, as run seeds may be


def small_cell(name: str, **render):
    """The cell ``name`` at 256x128 with small LUTs and shadow maps."""
    cell = load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["render"].update(SMALL, **render)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)
