"""Program counter: the (tile, slot) pairs that a frame's binning wrote into
its tile lists (each raster's ``offsets[-1]``), which the port's CUDA
graph copies on the device on every replay, summed over the frame's
rasters; mean over the counted
frames before the profiler started (layer: kernels). None where the
program keeps no such counter."""

from frame_bench.parts import counter


def read(run):
    return counter(run, "raster_pairs")
