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

from siammask_tpu_torch.ops.layout import memory_format

# at most this many windows without padding go through static slices
FEW_WINDOWS = 16


def unfold_windows(x: torch.Tensor, kernel: tuple[int, int], padding: int = 0,
                   stride: int = 1) -> torch.Tensor:
    """(N, C, H, W) -> (N, L, C, kh, kw) sliding windows, L row-major, in
    ``x``'s memory layout: the windows are cut from the map's view in memory
    order, so a channels_last map gives windows whose channels are
    innermost, and a merge of N and L into one axis is a channels_last view."""
    n, c, h, w = x.shape
    kh, kw = kernel
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    nhwc = memory_format(x) is torch.channels_last
    if padding > 0:
        x = F.pad(x, (padding, padding, padding, padding))
    t = x.permute(0, 2, 3, 1) if nhwc else x
    row = 1 if nhwc else 2                  # t's row axis; its column axis follows
    if padding == 0 and oh * ow <= FEW_WINDOWS:
        wins = torch.stack([t.narrow(row, i * stride, kh).narrow(row + 1, j * stride, kw)
                            for i in range(oh) for j in range(ow)], dim=1)
    else:
        v = t.unfold(row, kh, stride).unfold(row + 1, kw, stride)
        # NHWC (N, oh, ow, C, kh, kw) -> (N, oh, ow, kh, kw, C);
        # NCHW (N, C, oh, ow, kh, kw) -> (N, oh, ow, C, kh, kw)
        v = v.permute((0, 1, 2, 4, 5, 3) if nhwc else (0, 2, 3, 1, 4, 5))
        wins = v.reshape(n, oh * ow, *v.shape[3:])
    return wins.permute(0, 1, 4, 2, 3) if nhwc else wins


def unfold(x: torch.Tensor, kernel: tuple[int, int], padding: int = 0,
           stride: int = 1) -> torch.Tensor:
    """``F.unfold``'s function: (N, C, H, W) -> (N, C*kh*kw, L)."""
    win = unfold_windows(x, kernel, padding, stride)
    n, l = win.shape[:2]
    return win.permute(0, 2, 3, 4, 1).reshape(n, -1, l)
