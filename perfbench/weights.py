"""The benchmark's weights: drawn on the device from the seed, then set so
that random weights behave like a trained model's in the ways that matter
to the work and to the check.

1. ``model.init_weights``: every conv weight normal with variance
   1/fan_in from one draw, biases 0, BatchNorm the identity.
2. BatchNorm calibration on one template/search pair of the cell's own
   inputs: each BatchNorm's running mean 0 and running variance the mean
   square of its input, one number a layer (calibrated per channel, random
   weights are ill-conditioned in bf16).
3. Tracking only: the cls head's last conv set so that each anchor's
   foreground-minus-background logit has standard deviation 0.5 over that
   pair's score map (a calibrated random model scores every cell alike,
   which bf16 rounds into ties); the loc head's last conv scaled by 0.1
   (random box deltas move the box by its own width a frame); where the
   traffic asks, Refine's last conv set to a given mean and spread of the
   mask logits (Refine has no BatchNorm, so random weights give masks from
   a few hundred pixels to the whole frame, and from one contour to over a
   hundred, by seed: a polygon whose cost the seed sets).

Every step runs the plain reference in float32 with TF32 off; the program
is handed the finished dict and makes nothing of its own here.
"""
from __future__ import annotations

import torch

from perfbench.frames import device_generator
from perfbench.reference.model import Net, fp32_exact, init_weights, skip_windows, spec

WEIGHTS_STREAM = 1
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}   # a configuration's "dtype"


@torch.no_grad()
def make(family: str, width: int, seed: int, device, z: torch.Tensor, x: torch.Tensor,
         tracking: bool, mask_logits: dict | None = None) -> dict:
    """The weights dict of ``family`` ("sharp", "base"); z (1, 3, 127, 127)
    and x (1, 3, 255, 255) float32 crops of the cell's inputs.
    ``mask_logits`` ({"mean", "std"}, sharp only): Refine's last conv set so
    that the mask logits at the search crop's centre cell have that mean and
    standard deviation over the 127x127 cell."""
    p = init_weights(spec(family, width), device_generator(seed, WEIGHTS_STREAM, device),
                     device)
    with fp32_exact():
        net = Net(p, width)
        net.calibrate = True
        zf = net.template(z)
        xf = net.neck(net.backbone(x)[3])
        for name in ("rpn_model.cls", "rpn_model.loc", "mask_model.mask"):
            net.head(name, net.corr(name, zf, xf))
        net.calibrate = False
        if tracking:
            w, b = p["rpn_model.cls.head.3.weight"], p["rpn_model.cls.head.3.bias"]
            k = w.shape[0] // 2
            score = net.head("rpn_model.cls", net.corr("rpn_model.cls", zf, xf))
            logit = score[:, k:] - score[:, :k] - (b[k:] - b[:k])[None, :, None, None]
            scale = 0.5 / logit.std(dim=(0, 2, 3))
            w.mul_(scale.repeat(2)[:, None, None, None])
            b[:k] = 0.0
            b[k:] = -scale * logit.mean(dim=(0, 2, 3))
            p["rpn_model.loc.head.3.weight"].mul_(0.1)
            p["rpn_model.loc.head.3.bias"].mul_(0.1)
        if mask_logits:
            p0, p1, p2, p3 = net.backbone(x)
            corr = net.corr("mask_model.mask", zf, net.neck(p3))
            c = corr.shape[-1] // 2
            logits = net.refine(*skip_windows(p0, p1, p2, [c], [c]), corr[:, :, c, c])
            w, b = p["refine_model.post2.weight"], p["refine_model.post2.bias"]
            scale = mask_logits["std"] / logits.std()
            b.copy_(mask_logits["mean"] - scale * (logits.mean() - b))
            w.mul_(scale)
    return p


def load_into(model: torch.nn.Module, p: dict) -> torch.nn.Module:
    """The program's model (built on the meta device) given storage on the
    weights' device and the weights' values."""
    device = next(iter(p.values())).device
    model = model.to_empty(device=device)
    model.load_state_dict(p)
    return model
