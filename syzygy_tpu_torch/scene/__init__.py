"""Scene graph, lights, camera, packing (port of ``syzygy_tpu/scene``)."""
