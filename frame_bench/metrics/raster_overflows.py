"""Program counter: the raster launches of a frame whose tile lists
overflowed (``TileLists.overflow``: the kernel then iterates over every
slot, K3/K4), whose flags the port's CUDA graph copies on the device on
every replay, summed over the frame's rasters; mean over the counted
frames before the profiler started
(layer: kernels). None where the program keeps no such counter."""

from frame_bench.parts import counter


def read(run):
    return counter(run, "raster_overflows")
