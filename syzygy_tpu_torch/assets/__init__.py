"""Host-side assets (port of ``syzygy_tpu/assets``)."""
