"""Command-line scripts of the port (``python -m pangu_tpu_torch.scripts.<name>``)."""
