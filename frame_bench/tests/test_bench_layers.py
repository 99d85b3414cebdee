"""The readers of the port's per-replay records on a made-up run: the
window's frames are the graph's last replays, only the frames before the
profiler count, and a graph without records, or replays that do not line
up with the window, give nothing."""

import types
from typing import NamedTuple

import pytest
from conftest import CELLS

from frame_bench.harness import Frame, Run, Spans, load_cell
from frame_bench.metrics import (
    aerial_lut_dev_ms,
    encode_dev_ms,
    graph_nodes,
    lighting_dev_ms,
    replay_launch_ms,
    shadow_dev_ms,
    stage_ms,
    state_dev_ms,
)


class Replay(NamedTuple):
    """What the readers use of the port's replay record."""

    seq: int
    layer_ms: dict
    stage_ms: float
    replay_ms: float


LAYERS = ("state", "shadow", "gbuffer", "lighting", "encode")  # a frame without the atmosphere


def _replay(seq):
    """Replay ``seq``: layer j takes (j + 1) x (seq + 1) ms; stage 0.1 x
    seq ms, replay 0.5 ms."""
    layer_ms = {name: (j + 1.0) * (seq + 1) for j, name in enumerate(LAYERS)}
    return Replay(seq, layer_ms, 0.1 * seq, 0.5)


def _run(n_frames, replays, profiled_from=None, finished=None):
    frames = [Frame(k, float(k), float(k) + 0.2, counted=True) for k in range(1, n_frames + 1)]
    records = [_replay(s) for s in range(replays) if finished is None or s in finished]
    graph = {"config": None, "capture_s": 1.0, "pool_bytes": 0, "launches": {}, "layers": list(LAYERS),
             "nodes": {"state": 10, "stamps": 6, "total": 500}, "replays": replays, "read": lambda: records}
    run = Run(load_cell(CELLS[0]), 1, 1.0, 1.0, frames, Spans(), None, graph)
    if profiled_from is not None:
        run.trace = types.SimpleNamespace(profiled=list(range(profiled_from, profiled_from + 4)))
    return run


def test_window_frames_are_the_last_replays_before_the_profiler():
    run = _run(8, 9, profiled_from=5)  # replay 0 is the set-up's; frames 1-4 count
    assert state_dev_ms.read(run) == pytest.approx(1.0 * (2 + 3 + 4 + 5) / 4)
    assert lighting_dev_ms.read(run) == pytest.approx(4.0 * 3.5)
    assert encode_dev_ms.read(run) == pytest.approx(5.0 * 3.5)
    assert stage_ms.read(run) == pytest.approx(0.1 * 2.5)
    assert replay_launch_ms.read(run) == pytest.approx(0.5)
    assert graph_nodes.read(run) == 500.0


def test_unfinished_replays_are_left_out():
    run = _run(4, 5, finished={1, 3})
    assert shadow_dev_ms.read(run) == pytest.approx(2.0 * (2 + 4) / 2)


def test_nothing_to_read_gives_none():
    assert aerial_lut_dev_ms.read(_run(4, 5)) is None  # a layer the frame does not run
    assert state_dev_ms.read(_run(4, 4)) is None  # replays and frames do not line up
    assert state_dev_ms.read(_run(4, 5, finished=set())) is None
    parent = _run(4, 5)
    parent.graph = {"config": None, "capture_s": 1.0, "pool_bytes": 0, "launches": {}}  # a port without records
    assert state_dev_ms.read(parent) is None and stage_ms.read(parent) is None
    assert graph_nodes.read(parent) is None
    parent.graph = None  # no graph at all (a CPU run)
    assert state_dev_ms.read(parent) is None and graph_nodes.read(parent) is None
