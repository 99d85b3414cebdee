"""Frame metrics: FPS ring buffer + tick timing.

Port of ``syzygy_tpu/utils/metrics.py``: ``core/ringbuffer.hpp:9-49`` (a
500-sample FPS history with its average, written per frame at
``editor/editor.cpp:619``) and ``TickTiming`` (``core/timing.hpp:5-9``).
The performance window's plot becomes :meth:`RingBuffer.report`.
"""

from __future__ import annotations

import dataclasses


class RingBuffer:
    """Fixed 500-slot sample ring (``core/ringbuffer.hpp:11-38``)."""

    CAPACITY = 500

    def __init__(self):
        self._values = [0.0] * self.CAPACITY
        self._index = 0
        self._count = 0

    def write(self, value: float) -> None:
        self._values[self._index] = value
        self._index = (self._index + 1) % self.CAPACITY
        self._count = min(self._count + 1, self.CAPACITY)

    def current(self) -> float:
        return self._values[(self._index - 1) % self.CAPACITY]

    def average(self) -> float:
        if self._count == 0:
            return 0.0
        return sum(self._values[: self._count]) / self._count

    def values(self) -> list[float]:
        return self._values[: self._count]

    def history(self) -> list[float]:
        """Samples oldest first (the performance graph's x order,
        ``ui/statelesswidgets.cpp:98-161``)."""
        if self._count < self.CAPACITY:
            return self._values[: self._count]
        return self._values[self._index :] + self._values[: self._index]

    def report(self) -> str:
        vals = self.values()
        if not vals:
            return "no samples"
        return (
            f"avg {self.average():.1f} | min {min(vals):.1f} | "
            f"max {max(vals):.1f} | n {len(vals)}"
        )


@dataclasses.dataclass
class TickTiming:
    """``TickTiming`` (``core/timing.hpp:5-9``)."""

    time_elapsed_seconds: float = 0.0
    delta_time_seconds: float = 0.0
