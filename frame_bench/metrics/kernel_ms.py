"""Device trace: the summed device time of the kernels in the traced
stretch, per traced frame (layer: device)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernel_s() * 1e3 / len(run.trace.frames)
