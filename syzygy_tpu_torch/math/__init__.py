"""Math helpers (port of ``syzygy_tpu/math``)."""
