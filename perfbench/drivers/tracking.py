"""What the two tracking drivers share: the weights of a tracking cell, the
program's model and the tracker settings, the reference tracker in the
program's place (the control), and small statistics."""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import tracker as ref
from perfbench.reference.model import Net, fp32_exact


def first_crops(frame: torch.Tensor, box) -> tuple:
    """The template and search crops (1, 3, ...) of one box on a frame, as
    the tracker's init and first step take them."""
    box = torch.as_tensor(np.asarray(box, np.float32), device=frame.device)
    pos, sz = box[None, :2], box[None, 2:]
    avg = frame.float().mean(dim=(0, 1))[None]
    s_z = ref.context_size(sz)
    s_x = torch.round(s_z + 2 * ((ref.INSTANCE - ref.EXEMPLAR) / 2 / (ref.EXEMPLAR / s_z)))
    return (ref.crop(frame, pos, torch.round(s_z), ref.EXEMPLAR, avg),
            ref.crop(frame, pos, s_x, ref.INSTANCE, avg))


def tracking_weights(config: dict, seed: int, frame: torch.Tensor, box,
                     mask_logits: dict | None = None) -> dict:
    z, x = first_crops(frame, box)
    return weights.make(config["family"], config["width"], seed, frame.device, z, x,
                        tracking=True, mask_logits=mask_logits)


def program_model(config: dict, p: dict):
    """The program's SiamMask-sharp in the configuration's dtype, holding
    ``p`` (float32 weights: the deconv keeps float32, as loaded weights do)."""
    from siammask_tpu_torch.models.siammask import SiamMaskSharp

    with torch.device("meta"):
        model = SiamMaskSharp(config["anchor_num"], config["width"],
                              weights.DTYPES[config["dtype"]])
    return weights.load_into(model, p).eval()


def tracker_config(config: dict, hp_name: str):
    from siammask_tpu_torch.config import TrackerConfig

    return TrackerConfig().update(config["hp"][hp_name], config["anchors"])


class ReferenceTracker:
    """The plain tracker at ``precision`` over O objects, stateful: the
    control, put where the program runs."""

    def __init__(self, p: dict, config: dict, hp: dict, device, precision: str = "fp8"):
        self.net = Net({k: v.clone() for k, v in p.items()}, config["width"], precision)
        self.hp = hp
        self.device = device

    def init(self, frame: torch.Tensor, pos, sz):
        with fp32_exact(), torch.no_grad():
            self.pos = torch.as_tensor(np.asarray(pos, np.float32), device=self.device)
            self.sz = torch.as_tensor(np.asarray(sz, np.float32), device=self.device)
            self.template = ref.Template(self.net, frame, self.pos, self.sz)

    def step(self, frame: torch.Tensor) -> dict:
        with fp32_exact(), torch.no_grad():
            out = ref.step(self.net, self.hp, self.template, frame, self.pos, self.sz)
        self.pos, self.sz = out["pos"], out["sz"]
        return out


def mask_margin(binary: np.ndarray, soft: np.ndarray, thr: float) -> float:
    """The widest margin by which ``soft`` lies beyond ``thr`` at a pixel
    where ``binary`` says the other side (0 where they agree everywhere)."""
    wrong = binary.astype(bool) != (soft > thr)
    return float(np.abs(soft[wrong] - thr).max()) if wrong.any() else 0.0


def summarize(per: dict) -> dict:
    """Each reading's largest (its name) and mean (``.mean``) over the
    checked frames; infinite when no frame was checked."""
    out = {}
    for name, values in per.items():
        out[name] = max(values) if values else float("inf")
        out[f"{name}.mean"] = float(np.mean(values)) if values else float("inf")
    return out


def held(readings: dict, limits: dict, tag: str) -> list:
    """(name, value, limit) of the readings that ``limits`` names; the others
    are printed on stderr."""
    for name, value in readings.items():
        if name not in limits:
            print(f"{tag}: {name} {value!r} (read, not held)", file=sys.stderr)
    return [(name, readings[name], limit) for name, limit in limits.items()]


def iou_gap(a: np.ndarray, b: np.ndarray) -> float:
    """1 - IoU of two binary masks (0 when both are empty)."""
    a, b = a.astype(bool), b.astype(bool)
    union = np.logical_or(a, b).sum()
    return 0.0 if union == 0 else float(1.0 - np.logical_and(a, b).sum() / union)


def scale(sz) -> float:
    return math.sqrt(max(float(sz[0]) * float(sz[1]), 1.0))


class Reservoir:
    """A uniform sample of ``k`` of the items offered (Algorithm R), drawn
    from the seed."""

    def __init__(self, k: int, r: np.random.Generator):
        self.k, self.r, self.seen, self.items = k, r, 0, []

    def offer(self) -> int | None:
        """The slot the next item takes, or None when it is not kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.r.integers(0, self.seen))
        return j if j < self.k else None
