"""The memory layout of the model's maps.

Every map of the model is NCHW by shape. Its memory is NHWC
(``torch.channels_last``) when the model is handed such an input on a card:
cuDNN's Hopper convolutions take and give NHWC, so no conv then transposes
its input or its output. The model keeps whatever layout its input has:
each conv casts its weight into its input's layout (``models/resnet.py``
``Conv2d``), and the ops between convs keep their input's layout.

- ``memory_format(x)``: the layout of an NCHW map's memory.
- ``model_input(x)``: an NCHW image batch in the layout the model takes it
  in: NHWC memory for a CUDA tensor, NCHW elsewhere (the CPU path is the
  one the JAX package's tests hold the port to).
"""
from __future__ import annotations

import torch


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """``torch.channels_last`` where the NCHW tensor ``x`` holds its channels
    innermost in memory (NHWC memory, or a slice of it), else
    ``torch.contiguous_format``. A map of one pixel, whose two layouts are
    the same memory, is contiguous (as is one channel made NCHW)."""
    if x.stride(1) == 1 and max(x.stride(2), x.stride(3)) > 1:
        return torch.channels_last
    return torch.contiguous_format


def model_input(x: torch.Tensor) -> torch.Tensor:
    """An NCHW image batch (B, 3, H, W) as the model takes it: NHWC memory
    on a card (no copy where it is NHWC already, as the tracker's crops
    are), NCHW elsewhere."""
    fmt = torch.channels_last if x.is_cuda else torch.contiguous_format
    return x.contiguous(memory_format=fmt)
