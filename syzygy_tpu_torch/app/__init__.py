"""Headless renderer (port of ``syzygy_tpu/app``)."""
