"""Program counter: the device time of the frame's ``aerial_exact`` layer
(with ``aerial_lut=False``: the sky pass's per-pixel rays and materials
and the per-pixel in-scattering integrals), from the two stamps the
port's CUDA graph writes around it on every replay; mean over the
counted frames before the profiler started (layer: renderer.frame), ms.
None where the frame runs no such layer."""

from frame_bench.layers import layer_ms


def read(run):
    return layer_ms(run, "aerial_exact")
