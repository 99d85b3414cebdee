"""Output transfer functions and the demo compute collection (port of
``syzygy_tpu/kernels/transfer.py``: ``shaders/transfer/oetf_srgb.comp`` /
``oetf_pure_gamma.comp``, and the generic compute demos
``gradient_color.comp``, ``booleanpush.comp``, ``sparse_push_constant.comp``
and ``matrix_color.comp`` of the reference's ComputeCollectionPipeline).
Each demo takes its device as a required argument after the extent."""

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


def gradient_color(width: int, height: int, device, top_color=(1.0, 0.05, 0.05, 1.0),
                   bottom_color=(0.05, 0.05, 1.0, 1.0)) -> torch.Tensor:
    """``gradient_color.comp``: vertical mix(top, bottom, uv.y) -> (H, W, 4)."""
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    top = torch.as_tensor(top_color, dtype=torch.float32, device=device)
    bottom = torch.as_tensor(bottom_color, dtype=torch.float32, device=device)
    rows = top[None, :] * (1.0 - v[:, None]) + bottom[None, :] * v[:, None]
    return rows[:, None, :].expand(height, width, 4)


def _block_indices(width: int, height: int, device):
    """Pixel-centre uv and the 4x4 block each pixel falls in."""
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    iu = torch.clamp((u * 4).to(torch.int64), 0, 3)
    iv = torch.clamp((v * 4).to(torch.int64), 0, 3)
    return u, v, iu, iv


def boolean_push(width: int, height: int, device, rows) -> torch.Tensor:
    """``booleanpush.comp``: a 4x4 boolean grid, white/black blocks
    modulated by a (u, v, 0) tint. ``rows``: (4, 4) bool-ish."""
    rows = torch.as_tensor(rows, device=device).to(torch.float32)
    u, v, iu, iv = _block_indices(width, height, device)
    on = rows[iv[:, None], iu[None, :]]  # (H, W)
    base = torch.stack([on, on, on, torch.ones_like(on)], dim=-1)
    tint = torch.stack(
        [u[None, :].expand(height, width), v[:, None].expand(height, width),
         torch.zeros_like(on), torch.ones_like(on)],
        dim=-1,
    )
    return base * tint


def sparse_push(width: int, height: int, device, top_color, bottom_color) -> torch.Tensor:
    """``sparse_push_constant.comp``: the gradient again (the reference's
    sparse push-constant layout has no counterpart here; same output as
    :func:`gradient_color`)."""
    return gradient_color(width, height, device, top_color, bottom_color)


def matrix_color(width: int, height: int, device, red, green, blue) -> torch.Tensor:
    """``matrix_color.comp``: 4x4 push-constant color blocks."""
    _, _, iu, iv = _block_indices(width, height, device)
    planes = [
        torch.as_tensor(c, dtype=torch.float32, device=device)[iv[:, None], iu[None, :]]
        for c in (red, green, blue)
    ]
    return torch.stack([*planes, torch.ones_like(planes[0])], dim=-1)
