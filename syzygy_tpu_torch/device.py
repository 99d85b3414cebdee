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


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """numpy array / scalar -> tensor on ``device`` (float arrays stay f32,
    bool/int keep their kind)."""
    arr = np.array(x)  # contiguous copy; keeps 0-d shapes (ascontiguousarray would not)
    if dtype is None:
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr).to(device)
    return torch.as_tensor(arr, dtype=dtype).to(device)
