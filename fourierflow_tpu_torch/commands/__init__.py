"""Command-line entry points (``python -m fourierflow_tpu_torch.commands``)."""
