"""The end-to-end readers on a made-up run: ``frame_ms`` is the window
over the frames counted in it, with no chunk medians, and the p90 is taken
over every counted frame."""

import statistics

import pytest
from conftest import CELLS

from frame_bench.harness import Frame, Run, Spans, load_cell
from frame_bench.metrics import device_idle_pct, device_mem_mib, frame_ms, frame_p90_ms, issue_ms, pack_ms


def _run(latencies_ms, window_s, late=0):
    frames, t = [], 100.0
    for k, ms in enumerate(latencies_ms, start=1):
        frames.append(Frame(k, t, t + ms / 1e3, counted=True))
        t += ms / 1e3
    for j in range(late):
        frames.append(Frame(len(frames) + 1, t, t + 1.0, counted=False))
    spans = Spans()
    for f in frames:
        spans.records.append(("pack", f.k, f.t_input, f.t_input + 0.002))
        spans.records.append(("issue", f.k, f.t_input + 0.002, f.t_input + 0.003))
    return Run(load_cell(CELLS[1]), 1, 1.0, window_s, frames, spans, 3 * 2**20, None)


def test_frame_ms_is_the_window_over_the_counted_frames():
    lat = [200.0] * 9 + [1000.0]  # one stall
    run = _run(lat, window_s=sum(lat) / 1e3, late=2)
    assert frame_ms.read(run) == pytest.approx(sum(lat) / len(lat))
    assert frame_ms.read(run) > statistics.median(lat)  # a stall moves it


def test_p90_is_over_every_counted_frame():
    lat = [float(x) for x in range(1, 101)]
    run = _run(lat, window_s=sum(lat) / 1e3, late=3)
    assert frame_p90_ms.read(run) == pytest.approx(statistics.quantiles(lat, n=10, method="inclusive")[8])
    assert 89.0 < frame_p90_ms.read(run) < 92.0


def test_span_readers_and_memory():
    run = _run([200.0] * 5, window_s=1.0, late=1)
    assert pack_ms.read(run) == pytest.approx(2.0)
    assert issue_ms.read(run) == pytest.approx(1.0)
    assert device_mem_mib.read(run) == pytest.approx(3.0)


class _Event:
    """A CUDA event's stand-in: its time on the device's clock, ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_idle_is_the_time_no_frame_was_on_the_device():
    """One frame in flight: 10 ms of host work before each 190 ms frame;
    two in flight: each frame starts as the one before ends."""
    serial = _run([200.0] * 5, window_s=1.0)
    for i, f in enumerate(serial.frames):
        f.started, f.event = _Event(200.0 * i + 10.0), _Event(200.0 * (i + 1))
    assert device_idle_pct.read(serial) == pytest.approx(100.0 * 40.0 / 990.0)
    overlapped = _run([200.0] * 5, window_s=1.0)
    for i, f in enumerate(overlapped.frames):  # the start recorded while the frame before still ran
        f.started, f.event = _Event(190.0 * i - (5.0 if i else 0.0)), _Event(190.0 * (i + 1))
    assert device_idle_pct.read(overlapped) == pytest.approx(0.0)
    assert device_idle_pct.read(_run([200.0] * 5, window_s=1.0)) is None  # no events: not on a card
