"""Program counter: the device time of the rasters' triangle setup, the
parts ``shadow.setup`` (summed over the shadow-map slots: the corners'
light-space transform, the clip fan, the affine forms, the tile ranges,
the pixel boxes) and ``gbuffer.setup`` (the camera's), from the part
stamps the port's CUDA graph writes on every replay; mean over the
counted frames before the profiler started (layer: renderer.frame), ms.
None where the program keeps no such parts."""

from frame_bench.parts import parts_ms


def read(run):
    return parts_ms(run, ("shadow.setup", "gbuffer.setup"))
