"""Lane gather: ``out[i] = table[idx[i]]`` from a flat f32 LUT.

Port of the g7 probe of ``tools/gather_bench.py`` (``:229-258``): the
index is computed outside the kernel (:func:`lut_index`, the jnp
expression of ``:240-245``), then one kernel reads one table entry per
sample. On a CUDA tensor :func:`lane_gather` launches
``csrc/gather.cu``; on a CPU tensor it runs :func:`lane_gather_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from syzygy_tpu_torch.kernels import build


class LaunchCount:
    """Kernel launches, counted where :func:`lane_gather` launches the CUDA
    kernel and nowhere else."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.lane_gather = 0


LAUNCHES = LaunchCount()


def lut_index(u: torch.Tensor, v: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-texel flat index ``round(clip(v)(H-1)) * W + round(clip(u)(W-1))``
    as int32; ``torch.round`` rounds half to even, as ``jnp.round``."""
    uu = torch.clamp(u, 0.0, 1.0) * (width - 1)
    vv = torch.clamp(v, 0.0, 1.0) * (height - 1)
    return torch.round(vv).to(torch.int32) * width + torch.round(uu).to(torch.int32)


def lane_gather_plain(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather in plain torch."""
    return flat[idx.long()]


def _check(flat: torch.Tensor, idx: torch.Tensor) -> None:
    if flat.dtype != torch.float32 or flat.ndim != 1 or not flat.is_contiguous():
        raise ValueError("the table must be a contiguous 1-D float32 tensor")
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError("the indices must be a contiguous 1-D int32 tensor")
    if flat.device != idx.device:
        raise ValueError(f"table on {flat.device}, indices on {idx.device}")
    if flat.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no lane gather for device type {flat.device.type!r}")
    if idx.numel():
        lo, hi = (int(x) for x in torch.aminmax(idx))  # one host sync
        if lo < 0 or hi >= flat.numel():
            raise IndexError(f"indices span [{lo}, {hi}], the table holds {flat.numel()}")


def _launch(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked inputs (see :func:`lane_gather`)."""
    lib = build.load("gather")
    lib.szg_lane_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    lib.szg_lane_gather.restype = ctypes.c_int
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = lib.szg_lane_gather(flat.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), stream)
    if err != 0:
        raise RuntimeError(f"lane gather launch failed: CUDA error {err}")
    LAUNCHES.lane_gather += 1
    return out


def lane_gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` for a contiguous 1-D f32 table and 1-D int32 indices
    on one device, every index in range (checked: one host sync). CUDA
    tensors launch ``csrc/gather.cu``; CPU tensors run
    :func:`lane_gather_plain`."""
    _check(flat, idx)
    if flat.device.type == "cpu":
        return lane_gather_plain(flat, idx)
    return _launch(flat, idx)
