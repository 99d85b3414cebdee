"""Frame passes and the CUDA raster kernel wrapper (port of ``syzygy_tpu/kernels``)."""
