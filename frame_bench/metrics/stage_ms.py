"""Host clock: the port's ``stage`` span, the copy of the frame's
params row into its graph's input through the pinned ring (its wait for
the ring slot included) inside ``render_frame_packed``; mean over the
counted frames before the profiler started (layer: renderer.frame)."""

from frame_bench.layers import mean


def read(run):
    return mean(run, lambda r: r.stage_ms)
