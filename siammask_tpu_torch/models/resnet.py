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
"""
from __future__ import annotations

from torch import nn


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 bottleneck, BN after each."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        padding = dilation if dilation > 1 else 2 - stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=padding,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


def _make_layer(inplanes: int, planes: int, blocks: int, stride: int = 1,
                dilation: int = 1) -> nn.Sequential:
    """A stage of bottlenecks; the first one always has a downsample."""
    out = planes * Bottleneck.expansion
    if stride == 1 and dilation == 1:
        dd = 1
        downsample = nn.Sequential(nn.Conv2d(inplanes, out, 1, bias=False),
                                   nn.BatchNorm2d(out))
    else:
        dd, pad = (dilation // 2, dilation // 2) if dilation > 1 else (1, 0)
        downsample = nn.Sequential(
            nn.Conv2d(inplanes, out, 3, stride=stride, padding=pad, dilation=dd, bias=False),
            nn.BatchNorm2d(out))
    layers = [Bottleneck(inplanes, planes, stride, dd, downsample)]
    layers += [Bottleneck(out, planes, dilation=dilation) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50Tracking(nn.Module):
    """ResNet-50 layers 1-3. Input NCHW float32 raw 0..255 pixels (no
    normalisation, as the reference); returns (p0, p1, p2, p3)."""

    def __init__(self, width: int = 64):
        super().__init__()
        w = width
        self.conv1 = nn.Conv2d(3, w, 7, stride=2, padding=0, bias=False)
        self.bn1 = nn.BatchNorm2d(w)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = _make_layer(w, w, 3)
        self.layer2 = _make_layer(4 * w, 2 * w, 4, stride=2)
        self.layer3 = _make_layer(8 * w, 4 * w, 6, dilation=2)

    def forward(self, x):
        p0 = self.relu(self.bn1(self.conv1(x)))
        p1 = self.layer1(self.maxpool(p0))
        p2 = self.layer2(p1)
        p3 = self.layer3(p2)
        return p0, p1, p2, p3
