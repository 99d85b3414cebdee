"""Program counter: the device time of the G-buffer resolve
(``kernels/resolve.py::resolve_gbuffer``), the part ``gbuffer.resolve``,
from the part stamps the port's CUDA graph writes on every replay; mean
over the counted frames before the profiler started (layer:
renderer.frame), ms. None where the program keeps no such part."""

from frame_bench.parts import parts_ms


def read(run):
    return parts_ms(run, ("gbuffer.resolve",))
