"""Layer stamps: a timer reading written into a ring of replays.

:func:`stamp` writes the device's clock into column ``mark`` of the slot
``seq % rows`` of ``ring`` ((rows, stride) int64; its last column holds
each slot's sequence number), as ``csrc/stamp.cu`` states: the first mark
of a replay writes -1 there, its last writes the sequence number and
advances ``seq`` (an int64 scalar tensor). On a CUDA tensor it launches
the kernel; on a CPU tensor it runs :func:`stamp_plain`, which reads the
host's clock. A stamp given a raster's tile-list counters (its one-element
``overflow`` flag and ``pairs`` count) copies them into the two columns
after its mark. :func:`capture_nodes` counts the nodes of the CUDA graph
that the current stream is capturing into. ``kernels.build.LAUNCHES``
counts the kernel's launches by the ``kind`` the caller gives (``stamp``
at a layer's boundary, ``part`` at a part's).
"""

from __future__ import annotations

import ctypes
import time

import torch

from syzygy_tpu_torch.kernels import build


def _check(ring: torch.Tensor, seq: torch.Tensor, mark: int, overflow=None, pairs=None) -> None:
    if ring.dtype != torch.int64 or ring.dim() != 2 or not ring.is_contiguous() or ring.shape[1] < 2:
        raise ValueError("the ring must be a contiguous (rows, stride >= 2) int64 tensor")
    if seq.dtype != torch.int64 or seq.numel() != 1 or seq.device != ring.device:
        raise ValueError("seq must be one int64 on the ring's device")
    columns = 1 if overflow is None else 3  # the time, and the counters after it
    if not 0 <= mark <= ring.shape[1] - 1 - columns:
        raise ValueError(f"mark {mark} and {columns - 1} counters outside the ring's {ring.shape[1] - 1} columns")
    if (overflow is None) != (pairs is None):
        raise ValueError("a stamp copies both tile-list counters or neither")
    for t, dtype in ((overflow, torch.bool), (pairs, torch.int32)):
        if t is not None and (t.dtype != dtype or t.numel() != 1 or t.device != ring.device):
            raise ValueError(f"a tile-list counter must be one {dtype} on the ring's device")


def stamp_plain(ring: torch.Tensor, seq: torch.Tensor, mark: int, last: bool, overflow=None, pairs=None) -> None:
    """The kernel's semantics on the host's clock (ns)."""
    n = int(seq)
    slot = ring[n % ring.shape[0]]
    if mark == 0:
        slot[-1] = -1
    slot[mark] = time.perf_counter_ns()
    if overflow is not None:
        slot[mark + 1] = int(bool(overflow))
        slot[mark + 2] = int(pairs)
    if last:
        slot[-1] = n
        seq.fill_(n + 1)


def stamp(
    ring: torch.Tensor, seq: torch.Tensor, mark: int, last: bool, overflow: torch.Tensor | None = None,
    pairs: torch.Tensor | None = None, kind: str = "stamp",
) -> None:
    """One stamp on the ring's device (for a CUDA tensor, on the current
    stream, without waiting), with the tile-list counters ``overflow``
    (bool) and ``pairs`` (int32) where given; its launch counts as
    ``kind``."""
    _check(ring, seq, mark, overflow, pairs)
    device = ring.device.type
    if device == "cpu":
        stamp_plain(ring, seq, mark, last, overflow, pairs)
        return
    if device != "cuda":
        raise ValueError(f"no stamp for device type {device!r}")
    build.launch(
        "szg_stamp", ring.device, ring.data_ptr(), seq.data_ptr(), ring.shape[0], ring.shape[1], mark, int(last),
        None if overflow is None else overflow.data_ptr(), None if pairs is None else pairs.data_ptr(),
        counts={kind: 1},
    )


def capture_nodes(device: torch.device) -> int:
    """The nodes of the graph that the current stream of ``device`` is
    capturing into. Raises when it is capturing nothing."""
    count = ctypes.c_longlong(0)
    build.call("szg_capture_nodes", torch._C._cuda_getCurrentRawStream(device.index), ctypes.addressof(count))
    return count.value
