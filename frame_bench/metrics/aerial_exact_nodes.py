"""Program counter: the nodes (kernels, memsets, copies) of the cell's
CUDA graph inside its ``aerial_exact`` layer, counted by the port while
it captured the frame (``captured_frames()``' ``nodes``; layer:
renderer.frame). None where the frame runs no such layer."""


def read(run):
    nodes = run.graph.get("nodes") if run.graph else None
    return float(nodes["aerial_exact"]) if nodes and "aerial_exact" in nodes else None
