"""Plain float32 SiamMask-base stage-1 training step: forward, the three
losses, backward, the global gradient clip and SGD with momentum and weight
decay, over the weights dict of ``model.Net``.

The losses are those of foolwood/SiamMask ``models/siammask.py``
(``select_cross_entropy_loss``, ``weight_l1_loss``,
``select_mask_logistic_loss``): the 2-way log-softmax NLL averaged over
positive and over negative anchors, 0.5 each; the L1 of the box deltas
weighted and summed over the batch; the soft-plus mask loss of each selected
positive cell's 63x63 mask, bilinearly upsampled (align corners) to 127x127,
against its 127x127 window of the search mask padded by 32. The selected
cells are the top 16*B of the mask weights, as a static-shape gather.

Which parameters train, and which BatchNorms use batch statistics, follow
the published recipe's unfrozen phase (``features.unfix``): the stem and
layer1 frozen with running statistics; layer2, layer3, the neck and the
heads train. The optimizer: ``g`` clipped to a global norm of 10, then
``buf = momentum buf + (g + wd w)`` (``buf = g + wd w`` at the first step),
``w -= lr mult buf``, the backbone's mult 0.1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.model import Net

POS_PER_SAMPLE = 16
FROZEN = ("features.features.conv1", "features.features.bn1", "features.features.layer1.")


def trains(name: str) -> bool:
    """Whether a parameter (or a BatchNorm, by its prefix) trains in the
    unfrozen phase."""
    return not name.startswith(FROZEN)


def lr_mult(name: str) -> float:
    return 0.1 if name.startswith("features.features.") else 1.0


def losses(net: Net, batch: dict, anchor_num: int = 5, g_sz: int = 127, o_sz: int = 63,
           padding: int = 32):
    """(cls, loc, mask) losses of one batch, float32, differentiable."""
    zf = net.template(batch["template"])
    xf = net.neck(net.backbone(batch["search"])[3])
    cls, loc = net.rpn(zf, xf)
    mask = net.head("mask_model.mask", net.corr("mask_model.mask", zf, xf))

    b, _, s, _ = cls.shape
    logp = F.log_softmax(cls.view(b, 2, anchor_num, s, s), dim=1)
    label = batch["label_cls"]
    pos, neg = (label == 1).float(), (label == 0).float()
    cls_loss = 0.5 * -(logp[:, 1] * pos).sum() / pos.sum().clamp(min=1.0) \
        + 0.5 * -(logp[:, 0] * neg).sum() / neg.sum().clamp(min=1.0)

    diff = (loc.view(b, 4, anchor_num, s, s) - batch["label_loc"]).abs().sum(dim=1)
    loc_loss = (diff * batch["label_loc_weight"]).sum() / b

    weight = batch["label_mask_weight"].reshape(-1)
    sel_w, sel = torch.topk(weight, min(POS_PER_SAMPLE * b, weight.numel()))
    valid = (sel_w == 1).float()
    bi, cell = sel // (s * s), sel % (s * s)
    ys, xs = cell // s, cell % s
    padded = F.pad(batch["label_mask"], (padding,) * 4)
    ar = torch.arange(g_sz, device=padded.device)
    gt = padded[bi[:, None, None], (8 * ys)[:, None, None] + ar[None, :, None],
                (8 * xs)[:, None, None] + ar[None, None, :]].reshape(-1, g_sz * g_sz)
    pred = mask[bi, :, ys, xs].reshape(-1, 1, o_sz, o_sz)
    pred = F.interpolate(pred, size=(g_sz, g_sz), mode="bilinear", align_corners=True)
    per_row = F.softplus(-gt * pred.reshape(-1, g_sz * g_sz)).mean(dim=-1)
    mask_loss = (per_row * valid).sum() / valid.sum().clamp(min=1.0)
    return cls_loss, loc_loss, mask_loss


class SGDStep:
    """The optimizer state of the trained parameters of ``net.p``."""

    def __init__(self, net: Net, lr: float, momentum: float = 0.9, weight_decay: float = 1e-4,
                 clip: float = 10.0, loss_weight=(1.0, 1.2, 36.0)):
        self.net = net
        self.names = [k for k, v in net.p.items()
                      if trains(k) and v.is_floating_point()
                      and not k.endswith(("running_mean", "running_var"))]
        self.lr, self.momentum, self.wd, self.clip = lr, momentum, weight_decay, clip
        self.loss_weight = loss_weight
        self.buf: dict = {}

    def __call__(self, batch: dict):
        """One step; returns the (cls, loc, mask) losses as floats and the
        clipped gradients the optimizer took, by name."""
        p = self.net.p
        params = {k: p[k].detach().requires_grad_(True) for k in self.names}
        p.update(params)
        cls, loc, mask = losses(self.net, batch)
        w = self.loss_weight
        total = w[0] * cls + w[1] * loc + w[2] * mask
        grads = torch.autograd.grad(total, [params[k] for k in self.names])
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        coef = min(1.0, self.clip / (float(norm) + 1e-6))
        grads = {k: g * coef for k, g in zip(self.names, grads)}
        with torch.no_grad():
            for k in self.names:
                d = grads[k] + self.wd * params[k]
                self.buf[k] = d.clone() if k not in self.buf else \
                    self.buf[k].mul_(self.momentum).add_(d)
                p[k] = params[k].detach() - self.lr * lr_mult(k) * self.buf[k]
        return (float(cls.detach()), float(loc.detach()), float(mask.detach())), grads
