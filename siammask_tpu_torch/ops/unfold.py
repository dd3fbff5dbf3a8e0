"""Sliding-window extraction, the counterpart of ``siammask_tpu/ops/unfold.py``.

``unfold`` is ``torch.nn.functional.unfold``'s function: (N, C, H, W) ->
(N, C*kh*kw, L), features ordered (c, ki, kj) and the L windows row-major.
``unfold_windows`` gives the same windows as (N, L, C, kh, kw), the layout
Refine's training path takes. Taps that fall in the padding are zero.

Two lowerings, as in the JAX package: few windows without padding (Refine's
3x3 grid over the 143x143 stage-2 search) are static slices and one stack,
each window's bytes moved once; otherwise ``Tensor.unfold`` views of the
(padded) map, copied once into the window layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# at most this many windows without padding go through static slices
FEW_WINDOWS = 16


def unfold_windows(x: torch.Tensor, kernel: tuple[int, int], padding: int = 0,
                   stride: int = 1) -> torch.Tensor:
    """(N, C, H, W) -> (N, L, C, kh, kw) sliding windows, L row-major."""
    n, c, h, w = x.shape
    kh, kw = kernel
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    if padding == 0 and oh * ow <= FEW_WINDOWS:
        wins = [x[:, :, i * stride:i * stride + kh, j * stride:j * stride + kw]
                for i in range(oh) for j in range(ow)]
        return torch.stack(wins, dim=1)
    if padding > 0:
        x = F.pad(x, (padding, padding, padding, padding))
    v = x.unfold(2, kh, stride).unfold(3, kw, stride)      # (N, C, oh, ow, kh, kw)
    return v.permute(0, 2, 3, 1, 4, 5).reshape(n, oh * ow, c, kh, kw)


def unfold(x: torch.Tensor, kernel: tuple[int, int], padding: int = 0,
           stride: int = 1) -> torch.Tensor:
    """``F.unfold``'s function: (N, C, H, W) -> (N, C*kh*kw, L)."""
    win = unfold_windows(x, kernel, padding, stride)
    n, l = win.shape[:2]
    return win.permute(0, 2, 3, 4, 1).reshape(n, -1, l)
