"""Device trace: the least time of the traced frames' rasters
(:mod:`frame_bench.roofline`, counted from the scene and the targets)
over the device time of the ``raster_kernel`` launches in the stretch
(layer: kernels, ``csrc/raster.cu``), in percent."""


def read(run):
    if run.trace is None or run.roofline is None:
        return None
    device_s = run.trace.kernel_s("raster_kernel")
    return 100.0 * run.roofline.least_s / device_s if device_s > 0 else None
