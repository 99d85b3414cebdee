"""``captured_frames()``' ``pool_bytes`` of the cell's CUDA graph: the
device memory its capture added (layer: renderer.frame), MiB."""


def read(run):
    return run.graph["pool_bytes"] / 2**20 if run.graph else None
