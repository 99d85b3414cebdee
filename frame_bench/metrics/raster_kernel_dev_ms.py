"""Program counter: the device time of the raster kernels (``csrc/raster.cu``
over the tile lists, or by full iteration where they overflowed), the
parts ``shadow.raster`` (summed over the shadow-map slots, each map's
copy into its slot included) and ``gbuffer.raster``, from the part
stamps the port's CUDA graph writes on every replay; mean over the
counted frames before the profiler started (layer: renderer.frame), ms.
None where the program keeps no such parts."""

from frame_bench.parts import parts_ms


def read(run):
    return parts_ms(run, ("shadow.raster", "gbuffer.raster"))
