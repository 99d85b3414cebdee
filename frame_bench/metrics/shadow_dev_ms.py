"""Program counter: the device time of the frame's ``shadow`` layer (the
shadow-map slots: the zeroed map stack, each slot's setup, binning and
depth raster), from the two stamps the port's CUDA graph writes around
it on every replay; mean over the counted frames before the profiler
started (layer: renderer.frame), ms."""

from frame_bench.layers import layer_ms


def read(run):
    return layer_ms(run, "shadow")
