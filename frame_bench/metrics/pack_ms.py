"""Host clock around the harness's tick, camera move, pack and flatten of
each frame (layer: scene), averaged over the counted frames
before the profiler started."""


def read(run):
    return run.spans.mean_ms("pack", [f.k for f in run.untraced])
