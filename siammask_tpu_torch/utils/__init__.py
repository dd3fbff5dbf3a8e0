"""Box helpers, the JAX-to-PyTorch weight bridge, meters and logging."""
