"""Program counter: the least time of the kept frames' rasters
(:mod:`frame_bench.roofline`, counted from the scene with the plain
reference: the camera target and each shadow map the frame samples; mean
over the frames the check keeps) over the raster kernels' device time
(:mod:`raster_kernel_dev_ms`), in percent (layer: kernels). None where
the program keeps no such parts."""

import torch

from frame_bench.metrics import raster_kernel_dev_ms


def read(run):
    device_ms = raster_kernel_dev_ms.read(run)
    if not device_ms or not run.kept:
        return None
    from frame_bench.check import reference_frames
    from frame_bench.roofline import raster_work

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    least = [raster_work(g, p, c).least_s for _, g, p, c in reference_frames(run.cell, run.seed, device, run.kept)]
    return 100.0 * (sum(least) / len(least)) / (device_ms / 1e3)
