"""Command-line entry points of the port (``python -m plip_tpu_torch.scripts.<name>``)."""
