"""Program counter: the device time of the frame's ``lighting`` layer (the
sun's shared PCF where enabled, deferred lighting and its clamp), from
the two stamps the port's CUDA graph writes around it on every replay;
mean over the counted frames before the profiler started (layer:
renderer.frame), ms."""

from frame_bench.layers import layer_ms


def read(run):
    return layer_ms(run, "lighting")
