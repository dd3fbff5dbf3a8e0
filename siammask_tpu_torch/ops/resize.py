"""Resizes with the reference's PyTorch semantics.

- ``upsample_nearest``: ``F.interpolate(mode="nearest")`` maps output index i
  to input index ``floor(i * in / out)``, the map that
  ``siammask_tpu/ops/resize.py`` builds as one-hot matrices; the Refine
  decoder uses it.
- ``upsample_bilinear_align_corners``: ``nn.UpsamplingBilinear2d``, i.e.
  bilinear with ``align_corners=True`` (source ``i * (in - 1) / (out - 1)``),
  which the JAX package builds as interpolation matrices; the base mask loss
  uses it for the 63 -> 127 upsample.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize, as the JAX package's. The permutes are views: the
    interpolation runs on a channels-last NCHW view and returns one."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="nearest")
    return y.permute(0, 2, 3, 1)


def upsample_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True, as the JAX package's."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)
