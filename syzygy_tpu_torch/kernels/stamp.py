"""Layer stamps: a timer reading written into a ring of replays.

:func:`stamp` writes the device's clock into column ``mark`` of the slot
``seq % rows`` of ``ring`` ((rows, stride) int64; its last column holds
each slot's sequence number), as ``csrc/stamp.cu`` states: the first mark
of a replay writes -1 there, its last writes the sequence number and
advances ``seq`` (an int64 scalar tensor). On a CUDA tensor it launches
the kernel; on a CPU tensor it runs :func:`stamp_plain`, which reads the
host's clock. :func:`capture_nodes` counts the nodes of the CUDA graph
that the current stream is capturing into. :data:`LAUNCHES` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import time

import torch

from syzygy_tpu_torch.kernels import build


class LaunchCount:
    """Stamp kernels launched: counted by :func:`stamp` where it launches
    the CUDA kernel outside a graph capture, and by each replay of a
    captured frame for the stamps its graph holds
    (``renderer/layers.py::FrameTrace.replayed``); a stamp captured into a
    graph counts when the graph replays, not when it is captured."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.stamp = 0


LAUNCHES = LaunchCount()


def _check(ring: torch.Tensor, seq: torch.Tensor, mark: int) -> None:
    if ring.dtype != torch.int64 or ring.dim() != 2 or not ring.is_contiguous() or ring.shape[1] < 2:
        raise ValueError("the ring must be a contiguous (rows, stride >= 2) int64 tensor")
    if seq.dtype != torch.int64 or seq.numel() != 1 or seq.device != ring.device:
        raise ValueError("seq must be one int64 on the ring's device")
    if not 0 <= mark < ring.shape[1] - 1:
        raise ValueError(f"mark {mark} outside the ring's {ring.shape[1] - 1} time columns")


def stamp_plain(ring: torch.Tensor, seq: torch.Tensor, mark: int, last: bool) -> None:
    """The kernel's semantics on the host's clock (ns)."""
    n = int(seq)
    slot = ring[n % ring.shape[0]]
    if mark == 0:
        slot[-1] = -1
    slot[mark] = time.perf_counter_ns()
    if last:
        slot[-1] = n
        seq.fill_(n + 1)


def stamp(ring: torch.Tensor, seq: torch.Tensor, mark: int, last: bool) -> None:
    """One stamp on the ring's device (for a CUDA tensor, on the current
    stream, without waiting)."""
    _check(ring, seq, mark)
    kind = ring.device.type
    if kind == "cpu":
        stamp_plain(ring, seq, mark, last)
        return
    if kind != "cuda":
        raise ValueError(f"no stamp for device type {kind!r}")
    index = ring.device.index
    err = build.load("stamp").szg_stamp(
        ring.data_ptr(), seq.data_ptr(), ring.shape[0], ring.shape[1], mark, int(last),
        index, torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        raise RuntimeError(f"stamp kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES.stamp += 1


def capture_nodes(device: torch.device) -> int:
    """The nodes of the graph that the current stream of ``device`` is
    capturing into. Raises when it is capturing nothing."""
    count = ctypes.c_longlong(0)
    err = build.load("stamp").szg_capture_nodes(
        torch._C._cuda_getCurrentRawStream(device.index), ctypes.addressof(count)
    )
    if err != 0:
        raise RuntimeError(f"no graph node count: CUDA error {err}")
    return count.value
