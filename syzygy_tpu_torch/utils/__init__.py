"""Host utilities (port of ``syzygy_tpu/utils``)."""

from syzygy_tpu_torch.utils.metrics import RingBuffer, TickTiming
from syzygy_tpu_torch.utils.png import read_png, write_png

__all__ = ["RingBuffer", "TickTiming", "read_png", "write_png"]
