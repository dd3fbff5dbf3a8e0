"""Command-line entry points of the port: ``python -m siammask_tpu_torch.tools.<name>``
for ``test``, ``demo``, ``train``, ``tune``, ``eval``, ``curves`` and ``visualize``."""
