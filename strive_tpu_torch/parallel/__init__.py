"""Multi-device runs: one process a device (``mesh``)."""
