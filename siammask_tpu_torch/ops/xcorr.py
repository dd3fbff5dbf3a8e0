"""Depthwise cross-correlation between template and search features.

The signature SiamMask op (the reference's ``conv2d_dw_group``): the template
feature map is a per-(batch, channel) filter bank slid over the search map.

Layout is NHWC, as in the JAX package: search x (B, Hx, Wx, C), template
k (B, Hk, Wk, C) -> (B, Hx-Hk+1, Wx-Wk+1, C). For SiamMask:
(B, 29, 29, 256) * (B, 5, 5, 256) -> (B, 25, 25, 256), three times a frame
(B=1) or a training step (B=64).

- ``depthwise_xcorr``: the trainable op, the counterpart of the JAX
  package's ``depthwise_xcorr_ad``. It always goes through
  ``DepthwiseXcorr`` (a ``torch.autograd.Function``), whose forward and two
  gradients are hand-written kernels (``csrc/xcorr.cu``) on CUDA tensors and
  the plain versions below on CPU tensors. A CUDA tensor launches the kernel
  or raises.
- ``depthwise_xcorr_grad_input`` / ``depthwise_xcorr_grad_kernel``: the
  gradient wrappers the backward calls; the backward computes each only for
  an input that needs it.
- In bf16 each of the three launches one of two hand-written kernels,
  which ``uses_packed_kernel`` picks from the dtype, C, the template's size
  and the pointers' alignment: a packed kernel (two channels a lane, 4-byte
  loads; the model's shapes take it) or the kernel's bf16 instantiation
  (one channel a lane: odd C, or a storage offset that breaks the
  alignment). For the forward and grad-input both give the same bits; the
  packed grad-kernel sums in another order and differs from the scalar
  one by at most a bf16 rounding.
- Each wrapper counts its kernel launches in ``<wrapper>.launches``, a
  host counter that moves where the wrapper launches, and the packed
  kernel's among them in ``<wrapper>.packed_launches``. A launch captured
  into a CUDA graph counts once, at capture: each replay launches the kernel
  again without passing through the wrapper, so a graph path launches its
  captured count (``tracker.StepGraph.xcorr_launches``) times its replays.
- ``depthwise_xcorr_reference`` and the two ``*_reference`` gradients: the
  plain versions, grouped convs with groups=B*C.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from siammask_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/xcorr.cu's packed kernel: channels a lane (2 * kPackWords) and the
# largest template its register window holds (kTapRows x kTapCols)
_PACKED_CHANNELS = 2
_PACKED_TAPS = 5


def _to_groups(t: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B*C, H, W), channels of a sample adjacent."""
    b, h, w, c = t.shape
    return t.permute(0, 3, 1, 2).reshape(b * c, h, w)


def _from_groups(t: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(..., B*C, H, W) -> NHWC (B, H, W, C), a view."""
    h, w = t.shape[-2:]
    return t.reshape(b, c, h, w).permute(0, 2, 3, 1)


def depthwise_xcorr_reference(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: NHWC in and out, ``F.conv2d`` with groups=B*C."""
    b, _, _, c = x.shape
    out = F.conv2d(_to_groups(x)[None], _to_groups(k)[:, None], groups=b * c)
    return _from_groups(out, b, c)


def depthwise_xcorr_grad_input_reference(g: torch.Tensor, k: torch.Tensor, hx: int,
                                         wx: int) -> torch.Tensor:
    """Plain gradient w.r.t. the search map: the full correlation of the
    upstream grad g (B, Ho, Wo, C) with each channel's template, as the
    transposed grouped conv -> (B, hx, wx, C)."""
    b, _, _, c = g.shape
    dx = F.conv_transpose2d(_to_groups(g)[None], _to_groups(k)[:, None], groups=b * c)
    if dx.shape[-2:] != (hx, wx):
        raise ValueError(f"grad {tuple(g.shape)} and template {tuple(k.shape)} give a "
                         f"{tuple(dx.shape[-2:])} search map, not {(hx, wx)}")
    return _from_groups(dx, b, c)


def depthwise_xcorr_grad_kernel_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain gradient w.r.t. the template: per (b, c), the valid correlation
    of x (B, Hx, Wx, C) with g (B, Ho, Wo, C) -> (B, Hk, Wk, C)."""
    b, _, _, c = x.shape
    dk = F.conv2d(_to_groups(x)[None], _to_groups(g)[:, None], groups=b * c)
    return _from_groups(dk, b, c)


def _check_tensors(what: str, *ts: torch.Tensor) -> None:
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError(f"{what} takes tensors")
    if any(t.dim() != 4 for t in ts):
        raise ValueError(f"{what}: expected NHWC rank-4 tensors, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: inputs on different devices: {[t.device for t in ts]}")
    if ts[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {ts[0].device}")
    # float64 runs the plain versions only, on the CPU (float64 parity tests)
    dtypes = set(_DTYPE_CODE) | ({torch.float64} if ts[0].device.type == "cpu" else set())
    if len({t.dtype for t in ts}) != 1 or ts[0].dtype not in dtypes:
        raise TypeError(f"{what}: expected one of {sorted(map(str, dtypes))} for all, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous NHWC")


def _check(x: torch.Tensor, k: torch.Tensor) -> None:
    _check_tensors("depthwise_xcorr", x, k)
    b, hx, wx, c = x.shape
    bk, hk, wk, ck = k.shape
    if bk != b or ck != c:
        raise ValueError(f"batch/channels differ: x {tuple(x.shape)}, k {tuple(k.shape)}")
    if not (1 <= hk <= hx and 1 <= wk <= wx):
        raise ValueError(f"template {hk}x{wk} does not fit search {hx}x{wx}")


def uses_packed_kernel(*ts: torch.Tensor, template: int = 1) -> bool:
    """Whether a forward (x, k, out), grad-input (g, k, dx) or grad-kernel
    (x, g, dk) call on these tensors takes the packed bf16 kernel: bf16, C
    a multiple of the channels a lane, a template (``ts[template]``: k, or
    dk for grad-kernel, whose ``ts[1]`` is g) of at most 5x5 and every
    pointer aligned to a lane's load. Else it takes the kernel of its
    dtype, one channel a lane."""
    _, hk, wk, c = ts[template].shape
    align = 2 * _PACKED_CHANNELS    # bytes a lane loads
    return (ts[0].dtype == torch.bfloat16 and c % _PACKED_CHANNELS == 0
            and hk <= _PACKED_TAPS and wk <= _PACKED_TAPS
            and all(t.data_ptr() % align == 0 for t in ts))


def _launch(wrapper, entry: str, a: torch.Tensor, b_: torch.Tensor, out_shape: tuple,
            dims: tuple) -> torch.Tensor:
    """Launch one C entry on the current stream, the packed kernel where
    ``uses_packed_kernel`` says so, and count it on ``wrapper``; ``dims`` is
    (b, hx, wx, c, hk, wk). Raises on a non-zero CUDA code."""
    lib = _build.load_library()
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    packed = uses_packed_kernel(a, b_, out,
                                template=2 if wrapper is depthwise_xcorr_grad_kernel else 1)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = getattr(lib, entry)(a.data_ptr(), b_.data_ptr(), out.data_ptr(), *dims,
                               _DTYPE_CODE[a.dtype], int(packed), a.device.index,
                               ctypes.c_void_p(stream))
    _build.check(lib, code, f"{entry} launch" + (" (packed bf16 kernel)" if packed else ""))
    wrapper.launches += 1
    if packed:
        wrapper.packed_launches += 1
    return out


def _forward(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_xcorr_reference(x, k)
    b, hx, wx, c = x.shape
    _, hk, wk, _ = k.shape
    return _launch(depthwise_xcorr, "siammask_depthwise_xcorr", x, k,
                   (b, hx - hk + 1, wx - wk + 1, c), (b, hx, wx, c, hk, wk))


def depthwise_xcorr_grad_input(g: torch.Tensor, k: torch.Tensor, hx: int,
                               wx: int) -> torch.Tensor:
    """d out / d x: upstream grad g (B, Ho, Wo, C) and template k
    (B, Hk, Wk, C) -> (B, hx, wx, C). CUDA tensors run the kernel."""
    _check_tensors("depthwise_xcorr_grad_input", g, k)
    b, ho, wo, c = g.shape
    _, hk, wk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != c or (ho, wo) != (hx - hk + 1, wx - wk + 1):
        raise ValueError(f"grad {tuple(g.shape)} does not match template "
                         f"{tuple(k.shape)} and search {hx}x{wx}")
    if g.device.type == "cpu":
        return depthwise_xcorr_grad_input_reference(g, k, hx, wx)
    return _launch(depthwise_xcorr_grad_input, "siammask_depthwise_xcorr_grad_input", g, k,
                   (b, hx, wx, c), (b, hx, wx, c, hk, wk))


def depthwise_xcorr_grad_kernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d out / d k: search x (B, Hx, Wx, C) and upstream grad g
    (B, Ho, Wo, C) -> (B, Hx-Ho+1, Wx-Wo+1, C). CUDA tensors run the kernel."""
    _check_tensors("depthwise_xcorr_grad_kernel", x, g)
    b, hx, wx, c = x.shape
    _, ho, wo, _ = g.shape
    if g.shape[0] != b or g.shape[3] != c or not (1 <= ho <= hx and 1 <= wo <= wx):
        raise ValueError(f"grad {tuple(g.shape)} does not match search {tuple(x.shape)}")
    if x.device.type == "cpu":
        return depthwise_xcorr_grad_kernel_reference(x, g)
    hk, wk = hx - ho + 1, wx - wo + 1
    return _launch(depthwise_xcorr_grad_kernel, "siammask_depthwise_xcorr_grad_kernel", x, g,
                   (b, hk, wk, c), (b, hx, wx, c, hk, wk))


class DepthwiseXcorr(torch.autograd.Function):
    """The counterpart of ``depthwise_xcorr_ad``'s custom_vjp: forward and
    both gradients through the kernels on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return _forward(x, k)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        # the heads' NHWC -> NCHW permute hands back a strided grad
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_xcorr_grad_input(g, k, x.shape[1], x.shape[2])
        if ctx.needs_input_grad[1]:
            dk = depthwise_xcorr_grad_kernel(x, g)
        return dx, dk


def depthwise_xcorr(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """NHWC depthwise valid cross-correlation; fp32 accumulation, output in
    the input dtype; differentiable in both inputs. CUDA tensors run the
    hand-written kernels."""
    _check(x, k)
    return DepthwiseXcorr.apply(x, k)


depthwise_xcorr.launches = 0
depthwise_xcorr_grad_input.launches = 0
depthwise_xcorr_grad_kernel.launches = 0
depthwise_xcorr.packed_launches = 0
depthwise_xcorr_grad_input.packed_launches = 0
depthwise_xcorr_grad_kernel.packed_launches = 0
