"""SiamMask assemblies: backbone + neck + RPN heads + mask head (+ Refine).

Counterparts of ``SiamMaskBase`` and ``SiamMaskSharp`` in
``siammask_tpu/models/siammask.py``, in NCHW, with the reference
checkpoint's module tree: ``features.features`` (ResNet),
``features.downsample`` (neck), ``rpn_model``, ``mask_model`` and, for
sharp, ``refine_model``. Entry points:

- ``template(z)``                        -> zf (B, 256, 7, 7)
- ``SiamMaskBase.forward_train(z, x)``   -> (score, loc, mask):
  (B, 2k, 25, 25), (B, 4k, 25, 25), (B, 63*63, 25, 25)
- ``SiamMaskSharp.track_mask(zf, x)``    -> TrackOutputs(score, loc, skips, corr)
- ``SiamMaskSharp.track_refine(skips, corr, pos_yx)`` -> (B, 127*127) logits

cls channels are ordered (2, k) and loc channels (4, k), as the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from siammask_tpu_torch.models.heads import (MaskCorr, Refine, ResDownS, UP,
                                             DeconvExpand, slice_skip_windows)
from siammask_tpu_torch.models.resnet import ResNet50Tracking


class TrackOutputs(NamedTuple):
    score: torch.Tensor   # (B, 2k, S, S)
    loc: torch.Tensor     # (B, 4k, S, S)
    skips: tuple          # (p0, p1, p2) full search skip maps
    corr: torch.Tensor    # (B, 256, S, S) mask-branch corr feature


class ResDown(nn.Module):
    """Backbone + neck, named as the reference's ``features`` module."""

    def __init__(self, width: int = 64):
        super().__init__()
        self.features = ResNet50Tracking(width)
        self.downsample = ResDownS(16 * width, 4 * width)

    def forward(self, x):
        p0, p1, p2, p3 = self.features(x)
        return (p0, p1, p2), self.downsample(p3)


class _SiamMask(nn.Module):
    """What base and sharp share: backbone + neck, the RPN heads and the mask
    head. ``width`` is the backbone stem width: 64 is the published model;
    smaller widths keep the module tree and the spatial geometry."""

    def __init__(self, anchor_num: int = 5, width: int = 64):
        super().__init__()
        self.anchor_num = anchor_num
        self.width = width
        self.features = ResDown(width)
        self.rpn_model = UP(anchor_num, 4 * width, 4 * width)
        self.mask_model = MaskCorr(63, 4 * width, 4 * width)

    def template(self, z):
        return self.features(z)[1]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init with the JAX package's initialisers: convs
        LeCun-normal (truncated at 2 sigma), biases 0, BN identity, the
        deconv uniform with variance 1/(3 fan_in)."""
        for m in self.modules():
            if isinstance(m, DeconvExpand):
                bound = math.sqrt(1.0 / m.weight.shape[0])
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # flax's truncated normal: std corrected for the truncation
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self


class SiamMaskBase(_SiamMask):
    """Mask tracker without refinement: the mask head emits a 63x63 mask per
    score-map cell. Trained as stage 1 of the two-stage recipe."""

    def forward_train(self, template, search):
        """Template then search through the backbone, as two calls (each
        train-mode BN updates its running statistics twice, template first,
        as the JAX package's ``apply`` does); raw head outputs."""
        zf = self.template(template)
        _, xf = self.features(search)
        score, loc = self.rpn_model(zf, xf)
        return score, loc, self.mask_model(zf, xf)


class SiamMaskSharp(_SiamMask):
    """Flagship: the mask branch plus the U-shaped Refine to 127x127."""

    def __init__(self, anchor_num: int = 5, width: int = 64):
        super().__init__(anchor_num, width)
        self.refine_model = Refine(width)

    def track_mask(self, zf, x) -> TrackOutputs:
        """One search pass: RPN heads, the skip maps and the mask corr feature
        that ``track_refine`` consumes."""
        skips, xf = self.features(x)
        score, loc = self.rpn_model(zf, xf)
        corr = self.mask_model.mask.forward_corr(zf, xf)
        return TrackOutputs(score, loc, skips, corr)

    def track_refine(self, skips, corr, pos_yx: torch.Tensor):
        """Refined 127x127 mask logits at the (row, col) cell of each sample,
        ``pos_yx`` (B, 2), an integer device tensor: the windows and the corr
        vectors are gathered, not sliced on the host."""
        w0, w1, w2 = slice_skip_windows(*skips, pos_yx)
        b, c, _, s = corr.shape
        cell = pos_yx[:, 0] * s + pos_yx[:, 1]
        cvec = corr.flatten(2).gather(2, cell[:, None, None].expand(b, c, 1)).reshape(b, c)
        return self.refine_model(w0, w1, w2, cvec)
