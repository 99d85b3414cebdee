"""Frame graph (port of ``syzygy_tpu/renderer``)."""
