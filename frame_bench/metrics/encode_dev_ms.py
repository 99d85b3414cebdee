"""Program counter: the device time of the frame's ``encode`` layer (debug
lines, the supersample box filter, the OETF and the crop), from the two
stamps the port's CUDA graph writes around it on every replay; mean over
the counted frames before the profiler started (layer: renderer.frame),
ms."""

from frame_bench.layers import layer_ms


def read(run):
    return layer_ms(run, "encode")
