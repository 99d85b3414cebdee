"""Frame presentation: on-device u8 quantize, then one small D2H copy.

Port of ``syzygy_tpu/runtime.py``'s frame fetch. Its
``place_on_accelerator``/``accelerator_device`` have no counterpart here:
the port's constructors take their device explicitly, and
``scene.pack.pack_geometry(..., device)`` (or ``geometry_to_device``)
puts the packed scene where it renders.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_u8(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] float frame -> u8 on its own device, matching the reference's
    ``(clip(x, 0, 1) * 255 + 0.5).astype(u8)`` (``runtime.py:30-56``): the
    float->u8 conversion truncates toward zero."""
    return (torch.clamp(image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def fetch_frame_u8(image: torch.Tensor) -> np.ndarray:
    """Quantize on the device, then copy 1 byte per channel to the host."""
    return quantize_u8(image).cpu().numpy()
