"""Runnable examples of the port (``python -m sypha_tpu_torch.examples.<name>``)."""
