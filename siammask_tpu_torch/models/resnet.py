"""Tracking-variant ResNet-50 backbones (stride 8, dilated layer3, no layer4).

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
255 -> 125 / 63 / 31 / 31.

``ResNet50Stride8`` is the other padding of the same stages, torchvision's,
as TransT's backbone has it: a pad-3 stem, each 3x3 padded by its dilation,
1x1 downsamples with the stage's stride, and every 3x3 of layer3 at
dilation 2 and stride 1. A 256 input gives a 32x32 layer3 map, a 128 one
16x16. It shares ``Bottleneck`` and ``conv_bn``, so its eval-mode BN folds
into the same fused calls. ``width`` is the stem width (64 = ResNet-50);
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

Each conv -> BN (-> + residual) (-> ReLU) runs through ``conv_bn``: where
the pair folds (``folds``: BN in eval mode, no gradient through the pair,
no hook on either module, a CUDA input) it is one cuDNN call of the folded
weight and bias (``ops/bn_fold.py``), kept beside the conv
(``Conv2d.bn_folds``), and counted in ``conv.bn_folded``; otherwise the conv
runs, then ``bn_add_relu``: where the BN normalises with the batch's
statistics on a card's channels_last bf16 map (``trains_fused``), the BN,
add and ReLU are one ``torch.autograd.Function`` over the hand-written
kernels of ``ops/bn_train.py``, counted in ``bn.train_fused``; elsewhere the
module, the add and the ReLU in turn. The tracker on a card, and the
trainer's frozen stages there, fold; the trainer's training stages there
take the train-mode kernels; the CPU, float32 maps, a synced BN over ranks
and a BN with a hook run the modules. A block with a downsample runs it
bias-free when both its pairs fold, its folded bias added into conv3's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from siammask_tpu_torch.ops import bn_fold, bn_train
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
    in the trace counter ``conv.channels_last`` or ``conv.contiguous``.

    ``folded`` runs it with a BatchNorm folded in; ``bn_folds`` keeps the
    folded weights (``ops/bn_fold.py``)."""

    def __init__(self, *args, dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype
        self.bn_folds = bn_fold.FoldCache()

    def _input(self, x):
        """``x`` in the compute dtype, and its memory layout, counted."""
        fmt = memory_format(x)
        trace.count("conv.channels_last" if fmt is torch.channels_last else "conv.contiguous")
        return (x if self.dtype is None else x.to(self.dtype)), fmt

    def forward(self, x):
        x, fmt = self._input(x)
        if self.dtype is None:
            return self._conv_forward(x, self.weight.to(memory_format=fmt), self.bias)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return self._conv_forward(x, self.weight.to(self.dtype, memory_format=fmt), bias)

    def folded(self, bn: nn.BatchNorm2d, x, relu: bool = True, z=None, bias: bool = True,
               merge: nn.Module | None = None):
        """This bias-free conv with the eval-mode ``bn`` folded into it, one
        call (``ops/bn_fold.py`` ``conv_bias_relu``): ``relu`` and ``z`` as
        ``conv_bn``. ``bias=False`` leaves the folded bias out (a downsample
        whose bias the block's conv3 adds); ``merge``, such a downsample's
        (conv, BN) pair, whose folded bias is added to this pair's. The
        folded weight is in the compute dtype and the input's layout."""
        x, fmt = self._input(x)
        dtype = x.dtype
        pairs = ((self, bn),) if merge is None else ((self, bn), tuple(merge))

        def sources():
            return tuple(t for c, n in pairs
                         for t in (c.weight, n.weight, n.bias, n.running_mean, n.running_var))

        def make(*src):
            weight, b = bn_fold.fold(*src[:5], bn.eps)
            if merge is not None:
                b = b + bn_fold.fold(*src[5:], merge[1].eps)[1]
            return weight.to(dtype, memory_format=fmt), b.to(dtype)

        weight, b = self.bn_folds.get((x.device, dtype, fmt, merge is not None), sources, make)
        trace.count("conv.bn_folded")
        return bn_fold.conv_bias_relu(x, weight, b if bias else None, self.stride, self.padding,
                                      self.dilation, z, relu)


def folds(conv: Conv2d, bn: nn.BatchNorm2d, x) -> bool:
    """Whether the pair ``conv`` -> ``bn`` on the input ``x`` runs folded:
    its BN normalises with its running statistics (eval mode); no gradient
    flows through it (autograd is off, or neither its parameters nor ``x``
    ask for one); no forward hook or pre-hook watches either module (a
    hook sees the module's own input and output, which a fused call has
    not); and ``x`` lies where cuDNN runs the fused call (``bn_fold.
    DEVICES``: a card). Otherwise the two modules run as they are."""
    if bn.training or x.device.type not in bn_fold.DEVICES:
        return False
    if conv._forward_hooks or conv._forward_pre_hooks or bn._forward_hooks \
            or bn._forward_pre_hooks:
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or conv.weight.requires_grad or bn.weight.requires_grad
        or bn.bias.requires_grad))


def trains_fused(bn: nn.BatchNorm2d, x, z=None) -> bool:
    """Whether ``bn`` on the map ``x`` (then ``+ z``, then any ReLU) runs as
    the train-mode kernels of ``ops/bn_train.py``: the port's
    ``BatchNorm2d`` normalising with the batch's statistics (training mode,
    running statistics tracked, affine terms); ``x`` on a card
    (``bn_train.DEVICES``) in what the kernels take (``bn_train.supports``:
    channels_last bf16 maps, float32 vectors); no forward hook or pre-hook
    on ``bn`` (a hook sees the module's own input and output); and batch
    statistics of this rank alone (not ``synced``). Otherwise the module,
    the add and the ReLU run in turn."""
    if not (isinstance(bn, BatchNorm2d) and bn.training and bn.track_running_stats
            and bn.affine):
        return False
    if x.device.type not in bn_train.DEVICES or bn._forward_hooks or bn._forward_pre_hooks:
        return False
    return not bn.synced() and bn_train.supports(x, z, bn.weight, bn.bias, bn.running_mean,
                                                 bn.running_var)


def bn_add_relu(bn: nn.BatchNorm2d, x, relu: bool = True, z=None):
    """``bn`` of ``x``, then ``+ z`` where given, then ReLU where ``relu``:
    the fused train-mode kernels where ``trains_fused``, else the module,
    the add and the ReLU in turn."""
    if trains_fused(bn, x, z):
        return bn.fused(x, z, relu)
    out = bn(x)
    if z is not None:
        out = out + z
    return F.relu(out, inplace=True) if relu else out


def conv_bn(conv: Conv2d, bn: nn.BatchNorm2d, x, relu: bool = True, z=None):
    """``conv`` then ``bn``, then ``+ z`` where given, then ReLU where
    ``relu``: one fused call where the pair folds (``folds``), else the conv
    and ``bn_add_relu``."""
    if folds(conv, bn, x):
        return conv.folded(bn, x, relu, z)
    return bn_add_relu(bn, conv(x), relu, z)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance, in training mode, takes the
    biased batch variance, as flax's ``BatchNorm`` does (PyTorch's takes the
    unbiased one). The normalisation, parameters, buffers and state-dict
    keys are ``nn.BatchNorm2d``'s."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if trains_fused(self, x):
            return self.fused(x)
        self._check_input_dim(x)
        f = self._count_batch()
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

    def _count_batch(self) -> float:
        """Count the batch in ``num_batches_tracked``; the running
        statistics' momentum for it."""
        self.num_batches_tracked.add_(1)
        return self.momentum if self.momentum is not None else 1 / float(self.num_batches_tracked)

    def fused(self, x, z=None, relu: bool = False):
        """This training-mode BN of ``x``, then ``+ z``, then ReLU where
        ``relu``, as ``ops/bn_train.py``'s kernels (``trains_fused`` says
        where), counted in ``bn.train_fused``."""
        f = self._count_batch()
        trace.count("bn.train_fused")
        return bn_train.bn_train(x, self.weight, self.bias, self.running_mean, self.running_var,
                                 f, self.eps, z, relu)

    def synced(self) -> bool:
        """Whether its batch statistics span other ranks' rows
        (``parallel/sync_bn.py``): never for this class."""
        return False


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 bottleneck, BN after each.
    ``span``: its trace span's name (``ResNet50Tracking`` names each block)."""
    expansion = 4
    span = "model.backbone.block"

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: nn.Module | None = None, dtype: torch.dtype | None = None,
                 padding: int | None = None):
        super().__init__()
        if padding is None:             # the published SiamMask backbone's rule
            padding = dilation if dilation > 1 else 2 - stride
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=padding,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        with trace.span(self.span):
            ds = self.downsample
            fold_ds = ds is not None and folds(*ds, x)
            # an unfolded downsample runs first, as it always has: hooks on
            # the BNs see them in that order
            residual = conv_bn(*ds, x, relu=False) if ds is not None and not fold_ds else x
            out = conv_bn(self.conv1, self.bn1, x)
            out = conv_bn(self.conv2, self.bn2, out)
            if not fold_ds:
                return conv_bn(self.conv3, self.bn3, out, z=residual)
            if folds(self.conv3, self.bn3, out):
                # the residual's bias rides in conv3's epilogue: no pass of its own
                residual = ds[0].folded(ds[1], x, relu=False, bias=False)
                return self.conv3.folded(self.bn3, out, z=residual, merge=ds)
            return conv_bn(self.conv3, self.bn3, out, z=ds[0].folded(ds[1], x, relu=False))


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


def _torchvision_layer(inplanes: int, planes: int, blocks: int, stride: int = 1,
                       dilation: int = 1, dtype: torch.dtype | None = None) -> nn.Sequential:
    """A stage padded the torchvision way: a 1x1 downsample at the stage's
    stride, every 3x3 at ``dilation`` and padded by it."""
    out = planes * Bottleneck.expansion
    downsample = nn.Sequential(Conv2d(inplanes, out, 1, stride=stride, bias=False, dtype=dtype),
                               BatchNorm2d(out))
    layers = [Bottleneck(inplanes, planes, stride, dilation, downsample, dtype, dilation)]
    layers += [Bottleneck(out, planes, dilation=dilation, dtype=dtype, padding=dilation)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


def _name_blocks(net: nn.Module) -> None:
    # a span a block: a stage's span would hold too many host events for a
    # reader of the trace that looks back a few hundred
    for stage in ("layer1", "layer2", "layer3"):
        for i, block in enumerate(getattr(net, stage)):
            block.span = f"model.backbone.{stage}.{i}"


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
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = _make_layer(w, w, 3, dtype=dtype)
        self.layer2 = _make_layer(4 * w, 2 * w, 4, stride=2, dtype=dtype)
        self.layer3 = _make_layer(8 * w, 4 * w, 6, dilation=2, dtype=dtype)
        _name_blocks(self)
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
            p0 = conv_bn(self.conv1, self.bn1, x)
        p1 = self.layer1(self.maxpool(p0))
        p2 = self.layer2(p1)
        p3 = self.layer3(p2)
        return p0, p1, p2, p3


class ResNet50Stride8(nn.Module):
    """ResNet-50 layers 1-3 with torchvision's padding and a stride-1,
    dilation-2 layer3 (TransT's backbone; the module docstring). Input NCHW
    float32, normalised by the caller; returns the layer3 map (B, 16 width,
    H / 8, W / 8) in ``dtype`` when it is set, in the input's memory layout.
    Tracking only: every BN runs in eval mode unless ``train()`` is asked
    for."""

    def __init__(self, width: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        w = width
        self.conv1 = Conv2d(3, w, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(w)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = _torchvision_layer(w, w, 3, dtype=dtype)
        self.layer2 = _torchvision_layer(4 * w, 2 * w, 4, stride=2, dtype=dtype)
        self.layer3 = _torchvision_layer(8 * w, 4 * w, 6, dilation=2, dtype=dtype)
        _name_blocks(self)

    def forward(self, x):
        with trace.span("model.backbone.stem"):
            x = self.maxpool(conv_bn(self.conv1, self.bn1, x))
        return self.layer3(self.layer2(self.layer1(x)))
