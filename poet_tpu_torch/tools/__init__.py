"""Measurement drivers for the port; each runs as `python3 -m poet_tpu_torch.tools.<name>`."""
