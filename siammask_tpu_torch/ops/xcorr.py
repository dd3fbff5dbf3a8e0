"""Depthwise cross-correlation between template and search features.

The signature SiamMask op (the reference's ``conv2d_dw_group``): the template
feature map is a per-(batch, channel) filter bank slid over the search map.

Layout is NHWC, as in the JAX package: search x (B, Hx, Wx, C), template
k (B, Hk, Wk, C) -> (B, Hx-Hk+1, Wx-Wk+1, C). For SiamMask:
(1, 29, 29, 256) * (1, 5, 5, 256) -> (1, 25, 25, 256), three times a frame.

- ``depthwise_xcorr``: the wrapper. A CUDA tensor launches the hand-written
  kernel (``csrc/xcorr.cu``) or raises; a CPU tensor takes the plain version.
  ``depthwise_xcorr.launches`` counts kernel launches.
- ``depthwise_xcorr_reference``: the plain version, a grouped conv with
  groups=B*C.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from siammask_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def depthwise_xcorr_reference(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: NHWC in and out, ``F.conv2d`` with groups=B*C."""
    b, hx, wx, c = x.shape
    _, hk, wk, _ = k.shape
    xm = x.permute(0, 3, 1, 2).reshape(1, b * c, hx, wx)
    km = k.permute(0, 3, 1, 2).reshape(b * c, 1, hk, wk)
    out = F.conv2d(xm, km, groups=b * c)
    return out.reshape(b, c, hx - hk + 1, wx - wk + 1).permute(0, 2, 3, 1)


def _check(x: torch.Tensor, k: torch.Tensor) -> None:
    if not (isinstance(x, torch.Tensor) and isinstance(k, torch.Tensor)):
        raise TypeError("depthwise_xcorr takes two tensors")
    if x.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected NHWC rank-4 tensors, got {tuple(x.shape)} "
                         f"and {tuple(k.shape)}")
    if x.dtype != k.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"expected float32 or bfloat16 for both, got {x.dtype} "
                        f"and {k.dtype}")
    if x.device != k.device:
        raise ValueError(f"inputs on different devices: {x.device}, {k.device}")
    b, hx, wx, c = x.shape
    bk, hk, wk, ck = k.shape
    if bk != b or ck != c:
        raise ValueError(f"batch/channels differ: x {tuple(x.shape)}, k {tuple(k.shape)}")
    if not (1 <= hk <= hx and 1 <= wk <= wx):
        raise ValueError(f"template {hk}x{wk} does not fit search {hx}x{wx}")
    if not (x.is_contiguous() and k.is_contiguous()):
        raise ValueError("inputs must be contiguous NHWC")


def depthwise_xcorr(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """NHWC depthwise valid cross-correlation; fp32 accumulation, output in
    the input dtype. CUDA tensors run the hand-written kernel."""
    _check(x, k)
    if x.device.type == "cpu":
        return depthwise_xcorr_reference(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.requires_grad or k.requires_grad:
        raise NotImplementedError("the xcorr kernel has no backward yet")
    b, hx, wx, c = x.shape
    _, hk, wk, _ = k.shape
    lib = _build.load_library()
    out = torch.empty((b, hx - hk + 1, wx - wk + 1, c), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.siammask_depthwise_xcorr(
        x.data_ptr(), k.data_ptr(), out.data_ptr(), b, hx, wx, c, hk, wk,
        _DTYPE_CODE[x.dtype], x.device.index, ctypes.c_void_p(stream))
    _build.check(lib, code, "depthwise_xcorr launch")
    depthwise_xcorr.launches += 1
    return out


depthwise_xcorr.launches = 0
