"""Program counter: the device time of the frame's ``gbuffer`` layer (the
camera's triangle setup, visibility raster and G-buffer resolve), from
the two stamps the port's CUDA graph writes around it on every replay;
mean over the counted frames before the profiler started (layer:
renderer.frame), ms."""

from frame_bench.layers import layer_ms


def read(run):
    return layer_ms(run, "gbuffer")
