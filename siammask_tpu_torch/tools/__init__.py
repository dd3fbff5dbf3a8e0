"""Command-line entry points of the port: ``python -m siammask_tpu_torch.tools.test``."""
