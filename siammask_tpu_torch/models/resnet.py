"""Tracking-variant ResNet-50 backbone (stride 8, dilated layer3, pad-0 stem).

Counterpart of ``siammask_tpu/models/resnet.py`` in NCHW, with the reference
module names (``conv1``, ``bn1``, ``layer{1,2,3}.{i}.{conv,bn}{1,2,3}``,
``downsample.{0,1}``) so a reference checkpoint loads as it is. The quirks
of the published backbone are kept:

- the 7x7/2 stem has padding 0, then a 3x3/2 max pool with padding 1;
- a bottleneck's 3x3 conv pads ``2 - stride``, or ``dilation`` when dilated;
- layer2 starts with a 3x3/2 pad-0 conv and a 3x3/2 pad-0 downsample;
- layer3 (dilation 2) runs its first block at ``dilation // 2 = 1`` with a
  3x3 pad-1 downsample;
- there is no layer4.

Spatial flow: template 127 -> p0 61 -> p1 31 -> p2 15 -> p3 15; search
255 -> 125 / 63 / 31 / 31. ``width`` is the stem width (64 = ResNet-50);
smaller widths keep the module tree and the geometry.

Training state follows the reference's ``features.unfix``/``train``
override: the stem and layer1 never train (BN in eval, no gradient);
layer2 and layer3 train, BN in train mode, only after ``unfix(True)``. A
bare ``train()`` leaves every frozen stage in eval.

``dtype`` is the compute dtype, flax's module ``dtype``: every conv casts
its input and weight to it (``Conv2d``), so with ``torch.bfloat16`` the
activations are bf16 over float32 parameters. BatchNorm takes the bf16
conv output with its float32 statistics and affine terms, normalises in
float32 and returns bf16, as flax's ``BatchNorm(dtype=bf16)`` does. Its
running variance takes the biased batch variance, as flax's does
(``BatchNorm2d``).
``None`` (the default) casts nothing: the model computes in its
parameters' dtype, float32, or float64 after ``model.double()``.

The maps keep their input's memory layout (``ops/layout.py``): NHWC memory
(channels_last) where the tracker's crops and the trainer's batches come
from a card, NCHW on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from siammask_tpu_torch.ops.layout import memory_format
from siammask_tpu_torch.utils import trace


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` (flax's ``promote_dtype``):
    the input, weight and bias are cast to it and the output is in it; the
    parameters keep their own dtype. ``dtype=None`` casts nothing. Unlike
    ``nn.Conv2d``'s factory argument, ``dtype`` never sets the parameters'
    dtype.

    The weight the conv sees takes its input's memory layout
    (``ops/layout.py``) in the same ``.to`` that casts it, so a
    channels_last input meets a channels_last weight and gives a
    channels_last output: cuDNN transposes neither. The parameters stay as
    they are stored (NCHW-contiguous). Each call counts its input's layout
    in the trace counter ``conv.channels_last`` or ``conv.contiguous``."""

    def __init__(self, *args, dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        fmt = memory_format(x)
        trace.count("conv.channels_last" if fmt is torch.channels_last else "conv.contiguous")
        if self.dtype is None:
            return self._conv_forward(x, self.weight.to(memory_format=fmt), self.bias)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype, memory_format=fmt), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance, in training mode, takes the
    biased batch variance, as flax's ``BatchNorm`` does (PyTorch's takes the
    unbiased one). The normalisation, parameters, buffers and state-dict
    keys are ``nn.BatchNorm2d``'s."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        f = self.momentum if self.momentum is not None else 1 / float(self.num_batches_tracked)
        # the native update sets var <- (1 - f) var + f * batch_var * n / (n - 1);
        # from var * n / (n - 1), and times (n - 1) / n after it, that is
        # (1 - f) var + f * batch_var. The scaled copy, not the buffer, is
        # what autograd keeps.
        n = x.numel() // x.shape[1]
        scaled = self.running_var * (n / (n - 1))
        out = F.batch_norm(x, self.running_mean, scaled, self.weight, self.bias, True, f,
                           self.eps)
        with torch.no_grad():
            torch.mul(scaled, (n - 1) / n, out=self.running_var)
        return out


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 bottleneck, BN after each.
    ``span``: its trace span's name (``ResNet50Tracking`` names each block)."""
    expansion = 4
    span = "model.backbone.block"

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: nn.Module | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        padding = dilation if dilation > 1 else 2 - stride
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=padding,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        with trace.span(self.span):
            residual = x if self.downsample is None else self.downsample(x)
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            return self.relu(out + residual)


def _make_layer(inplanes: int, planes: int, blocks: int, stride: int = 1,
                dilation: int = 1, dtype: torch.dtype | None = None) -> nn.Sequential:
    """A stage of bottlenecks; the first one always has a downsample."""
    out = planes * Bottleneck.expansion
    if stride == 1 and dilation == 1:
        dd = 1
        downsample = nn.Sequential(Conv2d(inplanes, out, 1, bias=False, dtype=dtype),
                                   BatchNorm2d(out))
    else:
        dd, pad = (dilation // 2, dilation // 2) if dilation > 1 else (1, 0)
        downsample = nn.Sequential(
            Conv2d(inplanes, out, 3, stride=stride, padding=pad, dilation=dd, bias=False,
                   dtype=dtype),
            BatchNorm2d(out))
    layers = [Bottleneck(inplanes, planes, stride, dd, downsample, dtype)]
    layers += [Bottleneck(out, planes, dilation=dilation, dtype=dtype)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50Tracking(nn.Module):
    """ResNet-50 layers 1-3. Input NCHW float32 raw 0..255 pixels (no
    normalisation, as the reference); returns (p0, p1, p2, p3), in ``dtype``
    when it is set (the stem casts the pixels), in the input's memory
    layout."""

    def __init__(self, width: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        w = width
        self.conv1 = Conv2d(3, w, 7, stride=2, padding=0, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(w)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = _make_layer(w, w, 3, dtype=dtype)
        self.layer2 = _make_layer(4 * w, 2 * w, 4, stride=2, dtype=dtype)
        self.layer3 = _make_layer(8 * w, 4 * w, 6, dilation=2, dtype=dtype)
        # a span a block: a stage's span would hold too many host events for
        # a reader of the trace that looks back a few hundred
        for stage in ("layer1", "layer2", "layer3"):
            for i, block in enumerate(getattr(self, stage)):
                block.span = f"model.backbone.{stage}.{i}"
        self.unfrozen = False

    def _frozen_stages(self) -> list[nn.Module]:
        stages = [self.conv1, self.bn1, self.layer1]
        return stages if self.unfrozen else stages + [self.layer2, self.layer3]

    def unfix(self, unfrozen: bool) -> "ResNet50Tracking":
        """Freeze the stem and layer1, and layer2/3 unless ``unfrozen``:
        frozen parameters take no gradient and their BN runs in eval."""
        self.unfrozen = unfrozen
        self.requires_grad_(True)
        for m in self._frozen_stages():
            m.requires_grad_(False)
        return self.train(self.training)

    def train(self, mode: bool = True) -> "ResNet50Tracking":
        super().train(mode)
        for m in self._frozen_stages():
            m.eval()
        return self

    def forward(self, x):
        with trace.span("model.backbone.stem"):
            p0 = self.relu(self.bn1(self.conv1(x)))
        p1 = self.layer1(self.maxpool(p0))
        p2 = self.layer2(p1)
        p3 = self.layer3(p2)
        return p0, p1, p2, p3
