"""Image and feature ops; CUDA tensors go through the hand-written kernels."""
