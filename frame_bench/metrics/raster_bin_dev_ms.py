"""Program counter: the device time of the rasters' tile binning
(``kernels/raster.py::bin_triangles``), the parts ``shadow.bin`` (summed
over the shadow-map slots) and ``gbuffer.bin``, from the part stamps the
port's CUDA graph writes on every replay; mean over the counted frames
before the profiler started (layer: renderer.frame), ms. None where the
program keeps no such parts."""

from frame_bench.parts import parts_ms


def read(run):
    return parts_ms(run, ("shadow.bin", "gbuffer.bin"))
