"""The port's parts inside a layer and its device counters, read for the
window's frames as :mod:`frame_bench.layers` reads the layers.

Each replay of the port's CUDA graph stamps the boundaries of the parts
of a layer (``shadow.setup``, ``gbuffer.raster``, ...: the rasters'
setup, binning and raster, in every shadow-map slot, and the G-buffer
resolve) and copies each raster's tile-list counters
(``raster_overflows``, ``raster_pairs``); ``captured_frames()``'
``read`` sums them by name into each record's ``parts_ms`` and
``counters``. A program that keeps no such records gives None.
"""

from frame_bench.layers import mean


def parts_ms(run, names) -> float | None:
    """The mean over the window's frames of the summed device time of the
    parts ``names``, ms; None where a replay lacks one of them."""

    def value(replay):
        parts = getattr(replay, "parts_ms", None)
        if parts is None or any(name not in parts for name in names):
            return None
        return sum(parts[name] for name in names)

    return mean(run, value)


def counter(run, name: str) -> float | None:
    """The mean over the window's frames of device counter ``name``; None
    where a replay keeps no such counter."""

    def value(replay):
        counters = getattr(replay, "counters", None)
        return float(counters[name]) if counters is not None and name in counters else None

    return mean(run, value)
