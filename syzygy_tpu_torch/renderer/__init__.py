"""Frame graph (port of ``syzygy_tpu/renderer``)."""

from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame, render_frame_packed

__all__ = ["RenderConfig", "render_frame", "render_frame_packed"]
