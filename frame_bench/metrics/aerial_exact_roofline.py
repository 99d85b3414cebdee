"""Program counter: the least time of the kept frames' aerial integrals
(:mod:`frame_bench.aerial_work`, counted from the scene with the plain
reference; mean over the frames the check keeps) over the
``aerial_exact`` layer's device time (:mod:`aerial_exact_dev_ms`), in
percent (layer: kernels). None where the frame runs no such layer."""

import torch

from frame_bench.metrics import aerial_exact_dev_ms


def read(run):
    device_ms = aerial_exact_dev_ms.read(run)
    if not device_ms or not run.kept:
        return None
    from frame_bench.aerial_work import aerial_work
    from frame_bench.check import reference_frames

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    least = [aerial_work(g, p, c).least_s for _, g, p, c in reference_frames(run.cell, run.seed, device, run.kept)]
    return 100.0 * (sum(least) / len(least)) / (device_ms / 1e3)
