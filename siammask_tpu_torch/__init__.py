"""PyTorch/CUDA port of SiamMask-TPU for NVIDIA Hopper.

Module paths mirror ``siammask_tpu``; the port imports torch and numpy only.
"""
