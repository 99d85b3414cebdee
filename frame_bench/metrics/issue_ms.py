"""Host clock around each ``render_frame_packed`` call and the enqueue of
its copy to the host (layer: renderer.frame), which return before the
frame runs; averaged over the counted frames
before the profiler started."""


def read(run):
    return run.spans.mean_ms("issue", [f.k for f in run.untraced])
