"""The three model families: SiamRPN (box only), SiamMaskBase (63x63 masks)
and SiamMaskSharp (Refine to 127x127).

Counterparts of ``siammask_tpu/models/siammask.py``, in NCHW, with the
reference checkpoint's module tree: ``features.features`` (ResNet),
``features.downsample`` (neck), ``rpn_model``, then ``mask_model`` for the
mask families and ``refine_model`` for sharp. Each family's state_dict holds
only its own modules. Entry points:

- ``template(z)``                        -> zf (B, 256, 7, 7)
- ``track(zf, x)``                       -> (score, loc): (B, 2k, S, S), (B, 4k, S, S)
- ``SiamRPN.forward_train(z, x)``        -> (score, loc), with the modules' BN modes
- ``SiamMaskBase.track_mask(zf, x)``     -> (score, loc, mask), mask (B, 63*63, S, S)
- ``SiamMaskBase.forward_train(z, x)``   -> the same, with the modules' BN modes
- ``SiamMaskSharp.track_mask(zf, x)``    -> TrackOutputs(score, loc, skips, corr)
- ``SiamMaskSharp.track_refine(skips, corr, pos_yx)`` -> (B, 127*127) logits
- ``SiamMaskSharp.refine_all(skips, corr)`` -> (B*S*S, 127*127) logits
- ``SiamMaskSharp.forward_train(z, x, train_backbone_neck, train_rpn)``
                                         -> (score, loc, refined masks of every cell)

``build_model(arch)`` maps the reference's ``--arch`` names onto them. cls
channels are ordered (2, k) and loc channels (4, k), as the reference.

Each family takes ``dtype``, the compute dtype of the JAX package's models:
``torch.bfloat16`` runs bf16 activations over float32 parameters (every conv
casts its input and weight; ``models/resnet.py``), except Refine's deconv
(``heads.DeconvExpand``), whose weight and bias are created in bf16, as the
JAX package declares them; ``None`` (the default) computes in the
parameters' dtype. Weights loaded into a bf16 model keep their dtype, so a
bf16 twin of float32 weights holds a float32 deconv and computes a float32
product there, as JAX does on float32 arrays. Under bf16 the outputs are
bf16; the xcorr runs its bf16 kernels, forward and backward.

Building a float32 model (``dtype`` None or ``torch.float32``) switches
TF32 off for the whole process, ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` both False, so that its convs
and products run in full float32 on the card, the JAX package's float32
reference mode. A bf16 model leaves both flags as they are.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
from torch import nn

from siammask_tpu_torch.models.heads import (MaskCorr, Refine, ResDownS, UP,
                                             DeconvExpand, slice_skip_windows,
                                             unfold_skip_windows)
from siammask_tpu_torch.models.resnet import ResNet50Tracking
from siammask_tpu_torch.utils import trace


class TrackOutputs(NamedTuple):
    score: torch.Tensor   # (B, 2k, S, S)
    loc: torch.Tensor     # (B, 4k, S, S)
    skips: tuple          # (p0, p1, p2) full search skip maps
    corr: torch.Tensor    # (B, 256, S, S) mask-branch corr feature


class ResDown(nn.Module):
    """Backbone + neck, named as the reference's ``features`` module."""

    def __init__(self, width: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        self.features = ResNet50Tracking(width, dtype)
        self.downsample = ResDownS(16 * width, 4 * width, dtype)

    def forward(self, x):
        p0, p1, p2, p3 = self.features(x)
        with trace.span("model.neck"):
            return (p0, p1, p2), self.downsample(p3)


class SiamRPN(nn.Module):
    """Box-only tracker: backbone + neck + the RPN heads. ``width`` is the
    backbone stem width: 64 is the published model; smaller widths keep the
    module tree and the spatial geometry. ``dtype``: the compute dtype (the
    module docstring)."""

    family = "siamese"      # the tracker that ``TrackerRuntime`` builds for it

    def __init__(self, anchor_num: int = 5, width: int = 64, dtype: torch.dtype | None = None):
        super().__init__()
        if dtype in (None, torch.float32):   # the float32 reference mode
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.anchor_num = anchor_num
        self.width = width
        self.dtype = dtype
        self.features = ResDown(width, dtype)
        self.rpn_model = UP(anchor_num, 4 * width, 4 * width, dtype)

    def template(self, z):
        return self.features(z)[1]

    def track(self, zf, x):
        """One search pass through the RPN heads: (score, loc)."""
        _, xf = self.features(x)
        with trace.span("model.rpn"):
            return self.rpn_model(zf, xf)

    def forward_train(self, template, search):
        """Template then search through the backbone, as two calls (each
        train-mode BN updates its running statistics twice, template first,
        as the JAX package's ``apply`` does); raw (score, loc)."""
        return self.track(self.template(template), search)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random init with the JAX package's initialisers: convs
        LeCun-normal (truncated at 2 sigma), biases 0, BN identity, the
        deconv uniform with variance 1/(3 fan_in), in its parameter's dtype
        (a bf16 model's deconv: the float32 draws rounded to bf16)."""
        for m in self.modules():
            if isinstance(m, DeconvExpand):
                bound = math.sqrt(1.0 / m.weight.shape[0])
                # drawn in float32: a bf16 deconv is the float32 one, rounded
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound,
                                                                    generator=generator))
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


class _SiamMask(SiamRPN):
    """What base and sharp share: SiamRPN plus the mask head."""

    def __init__(self, anchor_num: int = 5, width: int = 64, dtype: torch.dtype | None = None):
        super().__init__(anchor_num, width, dtype)
        self.mask_model = MaskCorr(63, 4 * width, 4 * width, dtype)


class SiamMaskBase(_SiamMask):
    """Mask tracker without refinement: the mask head emits a 63x63 mask per
    score-map cell. Trained as stage 1 of the two-stage recipe."""

    def track_mask(self, zf, x):
        """One search pass: (score, loc, mask), the raw mask head over every
        cell, (B, 63*63, S, S)."""
        _, xf = self.features(x)
        with trace.span("model.rpn"):
            score, loc = self.rpn_model(zf, xf)
        with trace.span("model.mask"):
            return score, loc, self.mask_model(zf, xf)

    def forward_train(self, template, search):
        """Template then search through the backbone, as two calls, as
        ``SiamRPN.forward_train``; raw head outputs."""
        return self.track_mask(self.template(template), search)


@contextlib.contextmanager
def _frozen(module: nn.Module, frozen: bool):
    """While open and ``frozen``: ``module`` runs with eval-mode BN and
    records no gradient; each submodule's mode is restored after."""
    if not frozen:
        yield
        return
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        for m, mode in modes:
            m.training = mode


class SiamMaskSharp(_SiamMask):
    """Flagship: the mask branch plus the U-shaped Refine to 127x127.

    ``fix_for_refine(True)`` is stage 2 of the two-stage recipe (the
    reference's ``train_siammask_refine.py``): the backbone, neck and RPN
    heads take no gradient and keep eval-mode BN through later ``train()``
    calls; the mask corr and Refine train."""

    def __init__(self, anchor_num: int = 5, width: int = 64, dtype: torch.dtype | None = None):
        super().__init__(anchor_num, width, dtype)
        self.refine_model = Refine(width, dtype)
        self.refine_only = False

    def fix_for_refine(self, on: bool = True) -> "SiamMaskSharp":
        self.refine_only = on
        for m in (self.features, self.rpn_model):
            m.requires_grad_(not on)
        if not on:
            self.features.features.unfix(self.features.features.unfrozen)
        return self.train(self.training)

    def train(self, mode: bool = True) -> "SiamMaskSharp":
        super().train(mode)
        if self.refine_only:
            self.features.eval()
            self.rpn_model.eval()
        return self

    def track_mask(self, zf, x) -> TrackOutputs:
        """One search pass: RPN heads, the skip maps and the mask corr feature
        that ``track_refine`` consumes."""
        skips, xf = self.features(x)
        with trace.span("model.rpn"):
            score, loc = self.rpn_model(zf, xf)
        with trace.span("model.mask"):
            corr = self.mask_model.mask.forward_corr(zf, xf)
        return TrackOutputs(score, loc, skips, corr)

    def track_refine(self, skips, corr, pos_yx: torch.Tensor):
        """Refined 127x127 mask logits at the (row, col) cell of each sample,
        ``pos_yx`` (B, 2), an integer device tensor: the windows and the corr
        vectors are gathered, not sliced on the host, in any memory layout
        with no copy of the maps."""
        with trace.span("model.refine"):
            w0, w1, w2 = slice_skip_windows(*skips, pos_yx)
            return self.refine_model(w0, w1, w2, at_cells(corr, pos_yx))

    def refine_all(self, skips, corr):
        """Training path: Refine at every score-map cell -> (B*S*S, 127*127)
        logits, batch-major, cells row-major within a sample."""
        with trace.span("model.refine"):
            w0, w1, w2 = unfold_skip_windows(*skips)
            b, c, h, w = corr.shape
            cvec = corr.permute(0, 2, 3, 1).reshape(b * h * w, c)
            return self.refine_model(w0, w1, w2, cvec)

    def forward_train(self, template, search, train_backbone_neck: bool = True,
                      train_rpn: bool = True):
        """(score, loc, refined masks of every cell). Template then search
        through the backbone as two calls. ``train_backbone_neck=False``
        runs the backbone and neck, ``train_rpn=False`` the RPN heads, with
        eval-mode BN and no gradient (stage-2 refine training); the mask
        corr runs in its module's mode."""
        with _frozen(self.features, not train_backbone_neck):
            zf = self.template(template)
            skips, xf = self.features(search)
        with _frozen(self.rpn_model, not train_rpn), trace.span("model.rpn"):
            score, loc = self.rpn_model(zf, xf)
        with trace.span("model.mask"):
            corr = self.mask_model.mask.forward_corr(zf, xf)
        return score, loc, self.refine_all(skips, corr)


def at_cells(m: torch.Tensor, pos_yx: torch.Tensor) -> torch.Tensor:
    """The channel vector (B, C) of an NCHW map (B, C, S, S) at each sample's
    (row, col) cell ``pos_yx`` (B, 2): one gather, in any memory layout."""
    batch = torch.arange(m.shape[0], device=m.device)
    return m[batch, :, pos_yx[:, 0], pos_yx[:, 1]]


def log_softmax_cls(score: torch.Tensor, anchor_num: int) -> torch.Tensor:
    """Training-time cls activation of the reference: (B, 2k, S, S) raw
    scores -> (B, k, S, S, 2) log-softmax over the 2-way axis."""
    b, _, h, w = score.shape
    s = score.reshape(b, 2, anchor_num, h, w).permute(0, 2, 3, 4, 1)
    return torch.log_softmax(s, dim=-1)


def build_model(arch: str, anchor_num: int = 5, width: int = 64,
                dtype: torch.dtype | None = None, network: dict | None = None):
    """The model of a reference ``--arch`` name (``tools/test.py``):
    ``Custom``/``SiamMaskSharp``, ``SiamMaskBase`` or ``SiamRPN``, computing
    in ``dtype``; ``SAM2``, SAM 2.1 at the widths of ``Sam2Config`` updated
    by ``network["sam2"]`` (``network``: an experiment config's ``network``;
    none: the published Hiera-B+); or ``TransT``, at the widths of
    ``TransTConfig`` updated by ``network["transt"]`` (none: TransT-N4). A
    float32 SiamMask or TransT model switches the process's TF32 flags off
    (the module docstring)."""
    network = network or {}
    if arch == "SAM2":
        from siammask_tpu_torch.models.sam2 import Sam2, Sam2Config

        sizes = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in network.get("sam2", {}).items()}
        return Sam2(Sam2Config(**sizes), None if dtype == torch.float32 else dtype)
    if arch == "TransT":
        from siammask_tpu_torch.models.transt import TransT, TransTConfig

        return TransT(TransTConfig(**network.get("transt", {})), dtype)
    families = {"Custom": SiamMaskSharp, "SiamMaskSharp": SiamMaskSharp,
                "SiamMaskBase": SiamMaskBase, "SiamRPN": SiamRPN}
    if arch not in families:
        raise ValueError(f"unknown arch {arch!r}")
    return families[arch](anchor_num, width, dtype)
