"""Multi-device rendering over ``torch.distributed`` (port of ``syzygy_tpu/parallel``)."""

from syzygy_tpu_torch.parallel.sharding import (
    batch_params,
    make_mesh,
    render_frames_sharded,
    replicate_to_mesh,
)

__all__ = [
    "batch_params",
    "make_mesh",
    "render_frames_sharded",
    "replicate_to_mesh",
]
