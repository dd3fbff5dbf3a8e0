"""Seeded synthetic video: textured targets moving over a textured
background, rendered on the device in bulk.

After the pattern of the overfit tool's clip: a static background of smooth
random colour blobs with fine grain, each target a textured ellipse (one
random 16x16 texture a target, warm colours, scaled to its box), and fresh
pixel noise a frame. Each target's centre moves on a closed smooth path
(one period of a sine in x and one in y over the pool), so frame ``g`` of an
endless video is pool frame ``g % n`` and the motion stays smooth across
the wrap. Boxes are (cx, cy, w, h) in pixels.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one use of the seed."""
    return np.random.default_rng([seed, stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def paths(r: np.random.Generator, n: int, centres, sizes, amplitude: float) -> np.ndarray:
    """(n, T, 4) boxes: target t's centre ``centres[t] + amplitude (sin(2 pi
    i / n + a), sin(2 pi i / n + b))`` with a seeded phase each, its size
    fixed."""
    centres = np.asarray(centres, np.float64)
    sizes = np.asarray(sizes, np.float64)
    phase = r.uniform(0, 2 * math.pi, (len(centres), 2))
    t = 2 * math.pi * np.arange(n)[:, None, None] / n
    c = centres[None] + amplitude * np.sin(t + phase[None])
    return np.concatenate([c, np.broadcast_to(sizes[None], c.shape)], axis=2)


def render(gen: torch.Generator, boxes: np.ndarray, hw, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 frames of the (n, T, 4) boxes on the device."""
    h, w = hw
    n, targets = boxes.shape[:2]
    coarse = torch.randint(30, 180, (1, 3, h // 24 + 2, w // 24 + 2), generator=gen,
                           device=device).float()
    coarse[:, 2] *= 0.5
    background = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)[0]
    background += 12.0 * torch.randn(3, h, w, generator=gen, device=device)
    lo = torch.tensor([0.0, 60.0, 170.0], device=device)[:, None, None]
    hi = torch.tensor([90.0, 200.0, 255.0], device=device)[:, None, None]
    textures = lo + (hi - lo) * torch.rand(targets, 3, 16, 16, generator=gen, device=device)
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        im = background.clone()
        for t in range(targets):
            cx, cy, bw, bh = boxes[i, t]
            bw, bh = max(int(round(bw)), 2), max(int(round(bh)), 2)
            x0, y0 = int(round(cx - bw / 2)), int(round(cy - bh / 2))
            patch = F.interpolate(textures[t:t + 1], size=(bh, bw), mode="bilinear",
                                  align_corners=False)[0]
            yy = (torch.arange(bh, device=device)[:, None] + 0.5 - bh / 2) / (bh / 2)
            xx = (torch.arange(bw, device=device)[None, :] + 0.5 - bw / 2) / (bw / 2)
            inside = (xx * xx + yy * yy) <= 1.0
            ya, yb, xa, xb = max(y0, 0), min(y0 + bh, h), max(x0, 0), min(x0 + bw, w)
            if ya >= yb or xa >= xb:
                continue
            sub = im[:, ya:yb, xa:xb]
            sel = inside[ya - y0:yb - y0, xa - x0:xb - x0]
            sub[:, sel] = patch[:, ya - y0:yb - y0, xa - x0:xb - x0][:, sel]
        im += 6.0 * torch.randn(3, h, w, generator=gen, device=device)
        frames[i] = im.clamp_(0, 255).round_().to(torch.uint8).permute(1, 2, 0)
    return frames
