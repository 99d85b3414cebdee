"""Measurement tools of the port (``python -m syzygy_tpu_torch.tools.<name>``)."""
