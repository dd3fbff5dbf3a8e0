"""Attention for the SAM 2 family: scaled dot-product attention, axial RoPE
and the window partition of Hiera.

- ``attention(q, k, v)``: (B, heads, N, d) queries, keys and values. On a
  card in bf16 or fp16 the backend is pinned (``sdpa_kernel``), so a shape
  it cannot take raises instead of falling back to a slower one: cuDNN's
  fused attention at the head widths of ``CUDNN_WIDTHS`` (256: memory
  attention), PyTorch's FlashAttention-2 at the others, whose kernels are
  named ``pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<D, ...``
  (or ``flash_fwd_splitkv_kernel``), D the head width rounded up to a
  multiple of 32: 64 for Hiera's 56, 32 for the mask decoder's 32 and 16.
  Elsewhere (the CPU, float32 or float64) it is
  ``scaled_dot_product_attention`` with no backend pinned.
- ``axial_rope(dim, side, theta)``: the cos and sin of SAM 2's axial RoPE
  over a ``side`` x ``side`` grid (token ``i`` at x = i % side, y = i //
  side): ``dim / 2`` adjacent pairs, the first half rotated by x and the
  second by y, pair ``j`` of each half at frequency ``theta ** (-4 j /
  dim)``.
- ``apply_rope(x, cos, sin)``: rotates the pairs of ``x`` (..., N, dim) in
  float32 (float64 for a float64 ``x``) and returns ``x``'s dtype; N a multiple of the table's length
  repeats its phases (the memory bank's frames).
- ``window_partition`` / ``window_unpartition``: (B, H, W, C) maps to
  (B * windows, w, w, C) zero-padded windows and back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# head widths whose attention runs cuDNN's fused kernel on a card (SAM 2's
# memory attention: 683 against FlashAttention-2's 316 TFLOP/s on an H100
# at 16 x 4,096 queries over 28,736 keys)
CUDNN_WIDTHS = (256,)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, heads, N, d) tensors."""
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        backend = (SDPBackend.CUDNN_ATTENTION if q.shape[-1] in CUDNN_WIDTHS
                   else SDPBackend.FLASH_ATTENTION)
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)


def axial_rope(dim: int, side: int, theta: float, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(side * side, dim // 2) complex phases, of ``dtype``'s precision (the
    published tables are complex64)."""
    freqs = 1.0 / theta ** (torch.arange(0, dim, 4, device=device)[: dim // 4].to(dtype) / dim)
    t = torch.arange(side * side, device=device, dtype=dtype)
    tx, ty = t % side, torch.div(t, side, rounding_mode="floor")
    angles = torch.cat([torch.outer(tx, freqs), torch.outer(ty, freqs)], dim=-1)
    return torch.polar(torch.ones_like(angles), angles)


def apply_rope(x: torch.Tensor, phases: torch.Tensor) -> torch.Tensor:
    """x (..., N, dim) with pairs (2j, 2j + 1) rotated by the table's phase
    j, as one complex product; N = r * len(phases) takes the table r times
    over."""
    n, dim = x.shape[-2:]
    r = n // phases.shape[0]
    wide = torch.promote_types(x.dtype, torch.float32)
    z = torch.view_as_complex(x.to(wide).reshape(*x.shape[:-2], r, phases.shape[0], dim // 2, 2))
    return torch.view_as_real(z * phases).reshape(x.shape).to(x.dtype)


def window_partition(x: torch.Tensor, w: int) -> tuple:
    """(B, H, W, C) -> ((B * nh * nw, w, w, C), (Hp, Wp)), zero-padded at
    the bottom and right to multiples of ``w``."""
    b, h, wd, c = x.shape
    ph, pw = (w - h % w) % w, (w - wd % w) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, wd + pw
    x = x.view(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, w: int, pad_hw: tuple, hw: tuple) -> torch.Tensor:
    """The inverse of ``window_partition``, cropped to ``hw``."""
    hp, wp = pad_hw
    h, wd = hw
    b = windows.shape[0] // (hp * wp // w // w)
    x = windows.view(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hp, wp, -1)
    return x[:, :h, :wd] if (hp > h or wp > wd) else x
