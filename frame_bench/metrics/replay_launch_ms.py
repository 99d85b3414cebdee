"""Host clock: the port's ``replay`` span, the launch of the
frame's CUDA graph inside ``render_frame_packed``; mean over the counted
frames before the profiler started (layer: renderer.frame)."""

from frame_bench.layers import mean


def read(run):
    return mean(run, lambda r: r.replay_ms)
