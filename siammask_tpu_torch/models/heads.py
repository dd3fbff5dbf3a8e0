"""SiamMask heads: neck (ResDownS), DepthCorr RPN heads (UP), MaskCorr, Refine.

Counterpart of ``siammask_tpu/models/heads.py`` in NCHW, with the reference
module names (``downsample.{0,1}``, ``conv_kernel``/``conv_search``/``head``,
``v0..h2``, ``deconv``, ``post0..2``):

- ``ResDownS``: 1x1 conv + BN, cropping a 4 px border when the map is
  narrower than 20 px (template 15x15 -> 7x7).
- Every conv -> BN (-> ReLU) runs through ``resnet.conv_bn``: on a card
  with eval-mode BN, one call of the folded conv (``ops/bn_fold.py``).
- ``DepthCorr``: 3x3 conv+BN+ReLU on each side, the depthwise
  cross-correlation (``ops/xcorr.py``, NHWC), then a 1x1 head.
- ``UP``: the cls (2k channels) and loc (4k channels) DepthCorrs.
- ``MaskCorr``: a DepthCorr to o_sz**2 channels.
- ``Refine``: the U-shaped decoder fusing the p0/p1/p2 skip windows with the
  per-cell corr vector into 127x127 mask logits.

``dtype`` is the compute dtype of ``models/resnet.py``: each conv casts its
input and weight to it (``Conv2d``), and the xcorr takes the bf16 maps (its
kernels accumulate in float32 and write bf16). ``DeconvExpand`` is the one
layer whose parameters are created in ``dtype``, as the JAX package declares
them; loaded weights keep their own dtype (see its docstring). The maps keep
their input's memory layout (``ops/layout.py``), NHWC from a card's crops
and batches, through the xcorr, the window gathers and Refine.
"""
from __future__ import annotations

import torch
from torch import nn

from siammask_tpu_torch.models.resnet import BatchNorm2d, Conv2d, conv_bn
from siammask_tpu_torch.ops.layout import memory_format
from siammask_tpu_torch.ops.resize import upsample_nearest
from siammask_tpu_torch.ops.unfold import unfold_windows
from siammask_tpu_torch.ops.xcorr import depthwise_xcorr


class ResDownS(nn.Module):
    def __init__(self, in_channels: int = 1024, out_channels: int = 256,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.downsample = nn.Sequential(
            Conv2d(in_channels, out_channels, 1, bias=False, dtype=dtype),
            BatchNorm2d(out_channels))

    def forward(self, x):
        x = conv_bn(*self.downsample, x, relu=False)
        if x.shape[3] < 20:
            x = x[:, :, 4:-4, 4:-4]
        return x


class ConvBNRelu(nn.Sequential):
    """Unpadded conv (no bias) + BN + ReLU (``resnet.conv_bn``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 dtype: torch.dtype | None = None):
        super().__init__(Conv2d(in_channels, out_channels, kernel, bias=False, dtype=dtype),
                         BatchNorm2d(out_channels), nn.ReLU(inplace=True))

    def forward(self, x):
        return conv_bn(self[0], self[1], x)


class CorrHead(nn.Sequential):
    """DepthCorr's head: 1x1 conv (no bias) + BN + ReLU (``resnet.conv_bn``),
    then the 1x1 output conv with its bias."""

    def __init__(self, hidden: int, out_channels: int, dtype: torch.dtype | None = None):
        super().__init__(Conv2d(hidden, hidden, 1, bias=False, dtype=dtype),
                         BatchNorm2d(hidden), nn.ReLU(inplace=True),
                         Conv2d(hidden, out_channels, 1, dtype=dtype))

    def forward(self, x):
        return self[3](conv_bn(self[0], self[1], x))


class DepthCorr(nn.Module):
    """Template/search adjust convs + depthwise xcorr + 1x1 head."""

    def __init__(self, in_channels: int, hidden: int, out_channels: int,
                 kernel_size: int = 3, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv_kernel = ConvBNRelu(in_channels, hidden, kernel_size, dtype)
        self.conv_search = ConvBNRelu(in_channels, hidden, kernel_size, dtype)
        self.head = CorrHead(hidden, out_channels, dtype)

    def forward_corr(self, kernel, search):
        """NCHW in and out, in the search map's memory layout. The xcorr
        runs on NHWC: a channels_last map is that already (no copy), and
        its NHWC output goes back as a channels_last view; NCHW maps are
        copied to NHWC and the output back."""
        k = self.conv_kernel(kernel).permute(0, 2, 3, 1).contiguous()
        s = self.conv_search(search)
        corr = depthwise_xcorr(s.permute(0, 2, 3, 1).contiguous(), k)
        return corr.permute(0, 3, 1, 2).contiguous(memory_format=memory_format(s))

    def forward(self, kernel, search):
        return self.head(self.forward_corr(kernel, search))


class UP(nn.Module):
    """RPN heads: cls -> 2k channels, loc -> 4k channels, ordered (2, k) and
    (4, k) as the reference."""

    def __init__(self, anchor_num: int = 5, feature_in: int = 256, feature_out: int = 256,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cls = DepthCorr(feature_in, feature_out, 2 * anchor_num, dtype=dtype)
        self.loc = DepthCorr(feature_in, feature_out, 4 * anchor_num, dtype=dtype)

    def forward(self, z_f, x_f):
        return self.cls(z_f, x_f), self.loc(z_f, x_f)


class MaskCorr(nn.Module):
    """Mask head: each score-map cell predicts a flattened o_sz x o_sz mask."""

    def __init__(self, o_sz: int = 63, in_channels: int = 256, hidden: int = 256,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.mask = DepthCorr(in_channels, hidden, o_sz ** 2, dtype=dtype)

    def forward(self, z_f, x_f):
        return self.mask(z_f, x_f)


class DeconvExpand(nn.ConvTranspose2d):
    """ConvTranspose2d(in, out, k, stride=k) on a 1x1 input: a dense expand
    ``out[b, o, h, w] = sum_i x[b, i] * W[i, o, h, w] + bias[o]``, computed as
    one matrix product. The weight keeps torch's (in, out, kh, kw) layout.

    Its parameters are created in ``dtype`` (float32 when None), as the JAX
    package's ``DeconvExpand`` declares its kernel and bias in the compute
    dtype: a bf16 model built from scratch holds a bf16 weight and bias and
    computes a bf16 product, as JAX's bf16 ``model.init`` and einsum do.
    Loaded weights keep the dtype they arrive in (``_load_from_state_dict``),
    as flax keeps the arrays it is handed: float32 weights from the weight
    bridge or a float32 checkpoint stay float32 in a bf16 model. The product
    is in the promoted dtype of the input and the weight, so a bf16 corr
    vector times a float32 weight is a float32 product, as in JAX."""

    def __init__(self, in_features: int = 256, out_features: int = 32, size: int = 15,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, size, stride=size, dtype=dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, param in self._parameters.items():
            value = state_dict.get(prefix + name)
            if (isinstance(value, torch.Tensor) and value.is_floating_point()
                    and value.dtype != param.dtype):
                param.data = param.data.to(value.dtype)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        """x: (B, in) -> (B, out, size, size)."""
        i, o, h, w = self.weight.shape
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        y = (x.to(dtype) @ self.weight.to(dtype).reshape(i, o * h * w)).reshape(-1, o, h, w)
        return y + self.bias.to(dtype)[:, None, None]


class Conv3x3(Conv2d):
    """3x3 pad-1 conv with bias, in ``dtype`` (input, weight and bias cast,
    as the JAX package's ``Conv3x3`` casts its kernel and bias)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype | None = None):
        super().__init__(in_channels, out_channels, 3, padding=1, dtype=dtype)


class ConvReluBlock(nn.Sequential):
    """Two 3x3 pad-1 conv + ReLU layers (Refine's v/h blocks)."""

    def __init__(self, in_channels: int, mid: int, out: int, dtype: torch.dtype | None = None):
        super().__init__(Conv3x3(in_channels, mid, dtype), nn.ReLU(inplace=True),
                         Conv3x3(mid, out, dtype), nn.ReLU(inplace=True))


def _up(x, size):
    """Nearest upsample of an NCHW tensor through the NHWC op (views only)."""
    return upsample_nearest(x.permute(0, 2, 3, 1), (size, size)).permute(0, 3, 1, 2)


class Refine(nn.Module):
    """U-shaped mask refinement decoder.

    Consumes per-cell windows of the backbone skips, p0 (B,w,61,61),
    p1 (B,4w,31,31), p2 (B,8w,15,15), and the cell's corr vector (B, 4w);
    emits (B, 127*127) mask logits, in ``dtype`` when it is set.
    ``width`` is the backbone stem width."""

    def __init__(self, width: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        d = dtype
        self.v0 = ConvReluBlock(width, 16, 4, d)
        self.v1 = ConvReluBlock(4 * width, 64, 16, d)
        self.v2 = ConvReluBlock(8 * width, 128, 32, d)
        self.h2 = ConvReluBlock(32, 32, 32, d)
        self.h1 = ConvReluBlock(16, 16, 16, d)
        self.h0 = ConvReluBlock(4, 4, 4, d)
        self.deconv = DeconvExpand(4 * width, 32, 15, d)
        self.post0 = Conv3x3(32, 16, d)
        self.post1 = Conv3x3(16, 4, d)
        self.post2 = Conv3x3(4, 1, d)

    def forward(self, p0, p1, p2, corr):
        # the deconv's product is NCHW: it takes the skip windows' layout
        out = self.deconv(corr).contiguous(memory_format=memory_format(p2))  # (B,32,15,15)
        out = self.post0(_up(self.h2(out) + self.v2(p2), 31))
        out = self.post1(_up(self.h1(out) + self.v1(p1), 61))
        out = self.post2(_up(self.h0(out) + self.v0(p0), 127))
        return out.reshape(out.shape[0], 127 * 127)


def slice_skip_windows(p0, p1, p2, pos_yx: torch.Tensor):
    """Skip windows at one score-map cell per sample, for the inference path.

    p0/p1/p2 are the full NCHW search skip maps (B, C, H, W); pos_yx (B, 2)
    is the (row, col) cell of each sample, an integer device tensor, so
    nothing syncs. The reference pads by
    (16, 8, 4) and slices windows of (61, 31, 15) at strides (4, 2, 1) from
    the cell; a clamped gather over the maps' NHWC view, with an
    out-of-bounds zero mask, gives the same windows without padded copies.
    The windows and their zero fill are in the maps' dtype and memory
    layout (channels_last maps give channels_last windows, no copy)."""
    y, x = pos_yx[:, :1], pos_yx[:, 1:]
    batch = torch.arange(pos_yx.shape[0], device=pos_yx.device)[:, None, None]

    def win_gather(f, pad, scale, win):
        n = f.shape[2]
        ar = torch.arange(win, device=f.device)
        r = scale * y - pad + ar                      # (B, win)
        c = scale * x - pad + ar
        g = f.permute(0, 2, 3, 1)[batch, r.clamp(0, n - 1)[:, :, None],
                                  c.clamp(0, n - 1)[:, None, :]]      # (B, win, win, C)
        valid = ((r >= 0) & (r < n))[:, :, None] & ((c >= 0) & (c < n))[:, None, :]
        g = g * valid[..., None].to(g.dtype)
        return g.permute(0, 3, 1, 2).contiguous(memory_format=memory_format(f))

    return (win_gather(p0, 16, 4, 61),
            win_gather(p1, 8, 2, 31),
            win_gather(p2, 4, 1, 15))


def unfold_skip_windows(p0, p1, p2):
    """Skip windows at every score-map cell, for the training path: windows
    of (61, 31, 15) at strides (4, 2, 1) without padding, each (B*L, C, win,
    win), batch-major with the L cells row-major within a sample (the
    reference's ``F.unfold`` then ``view(-1, C, w, w)``)."""
    merge = lambda w: w.reshape((-1,) + w.shape[2:])
    return (merge(unfold_windows(p0, (61, 61), stride=4)),
            merge(unfold_windows(p1, (31, 31), stride=2)),
            merge(unfold_windows(p2, (15, 15), stride=1)))
