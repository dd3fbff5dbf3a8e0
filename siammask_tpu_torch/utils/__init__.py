"""Box helpers and the JAX-to-PyTorch weight bridge."""
