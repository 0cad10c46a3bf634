"""Entry points of the port (run as ``python -m strive_tpu_torch.scripts.<name>``)."""
