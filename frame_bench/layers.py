"""The port's own records of each replay, read for the window's frames.

The port keeps, per captured frame, the device time of each of its layers
(stamps captured into the CUDA graph) and the host time of its ``stage``
and ``replay`` spans, for every replay; ``captured_frames()``' ``read``
returns the finished ones with their sequence numbers. The set-up's first
call captures the graph and its second replays it once, so the window's
frames are the graph's last replays, frame k the replay numbered k. A
program that keeps no such records (no ``read``), or replays that do not
line up with the window's frames, give None.
"""


def window_replays(run) -> list | None:
    """The finished replays of the counted frames before the profiler
    started (:attr:`frame_bench.harness.Run.untraced`), or None."""
    graph = run.graph
    if not graph or "read" not in graph:
        return None
    if graph["replays"] != len(run.frames) + 1:  # the set-up's replay and the window's
        return None
    first = graph["replays"] - len(run.frames)  # frame 1's sequence number
    wanted = {first + f.k - 1 for f in run.untraced}
    found = [r for r in graph["read"]() if r.seq in wanted]
    return found or None


def mean(run, value) -> float | None:
    """The mean of ``value(replay)`` over :func:`window_replays`, leaving
    out replays where it is None."""
    values = [value(r) for r in window_replays(run) or ()]
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def layer_ms(run, name: str) -> float | None:
    """The mean device time of layer ``name`` (the difference of its two
    stamps), ms; None where the frame runs no such layer."""
    return mean(run, lambda r: r.layer_ms.get(name))
