"""Nearest resize with PyTorch ``F.upsample`` semantics.

``F.interpolate(mode="nearest")`` maps output index i to input index
``floor(i * in / out)``, the map that ``siammask_tpu/ops/resize.py`` builds as
one-hot matrices; the Refine decoder uses it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize, as the JAX package's. The permutes are views: the
    interpolation runs on a channels-last NCHW view and returns one."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="nearest")
    return y.permute(0, 2, 3, 1)
