"""Output transfer functions (port of ``syzygy_tpu/kernels/transfer.py``,
``shaders/transfer/oetf_srgb.comp`` / ``oetf_pure_gamma.comp``)."""

from __future__ import annotations

import torch


def oetf_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB encode (``oetf_srgb.comp:9-19``)."""
    linear = torch.clamp(linear, 0.0, 1.0)
    lower = 12.92 * linear
    higher = 1.055 * torch.pow(torch.clamp(linear, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(linear <= 0.0031308, lower, higher)


def oetf_pure_gamma(linear: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """``oetf_pure_gamma.comp``: pow(1/gamma)."""
    return torch.pow(torch.clamp(linear, 0.0, 1.0), 1.0 / gamma)
