"""Explicit device handling: every entry point names its device."""

from __future__ import annotations

import numpy as np
import torch


def as_device(device) -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` -> ``torch.device``.

    A CUDA device that is not available raises; there is no silent CPU
    carry-on."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is unavailable")
    return dev


_CONSTANTS: dict = {}


def constant(values, dtype, device) -> torch.Tensor:
    """A tensor of host constants on ``device``, made once per (values,
    dtype, device) and shared by every caller, so a frame that reads its
    constants from here copies nothing from the host (a copy from pageable
    host memory waits for the stream, and a CUDA graph cannot capture it).
    Read it; never write to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (repr(values), dtype, dev)  # repr keeps -0.0 apart from 0.0
    table = _CONSTANTS.get(key)
    if table is None:
        table = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=dev)
    return table


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """numpy array / scalar -> tensor on ``device`` (float arrays stay f32,
    bool/int keep their kind)."""
    arr = np.array(x)  # contiguous copy; keeps 0-d shapes (ascontiguousarray would not)
    if dtype is None:
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr).to(device)
    return torch.as_tensor(arr, dtype=dtype).to(device)
