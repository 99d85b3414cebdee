"""Program counter: the nodes (kernels, memsets, copies) of the cell's
CUDA graph, counted by the port while it captured the frame
(``captured_frames()``' ``nodes``; layer: renderer.frame)."""


def read(run):
    nodes = run.graph.get("nodes") if run.graph else None
    return float(nodes["total"]) if nodes else None
