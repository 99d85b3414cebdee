"""syzygy_tpu_torch — the syzygy deferred renderer in PyTorch + CUDA.

A port of ``syzygy_tpu`` (JAX/Pallas) to PyTorch for an NVIDIA H100. The
module layout mirrors the JAX package path for path (``math/``,
``assets/``, ``scene/``, ``kernels/``, ``renderer/``, ``app/``), so every
function's reference lives at the same relative path there.

Plain tensor code is PyTorch; the one TPU kernel of the frame (the
visibility/shadow rasterizer, ``syzygy_tpu/kernels/raster.py``) is a
hand-written CUDA kernel, ``csrc/raster.cu``, built at first use.

Every entry point takes an explicit ``device``; nothing reads a global
default device.
"""

import torch as _torch

# True float32 everywhere (the counterpart of the JAX package's
# ``jax_default_matmul_precision=highest`` pin): TF32 would move 4x4
# transforms and LUT math by ~1e-3.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
