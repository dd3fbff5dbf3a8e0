"""Box geometry helpers (host-side numpy), with the reference's formulas."""
from __future__ import annotations

import numpy as np


def corner2center(corner):
    """(x1, y1, x2, y2) -> (cx, cy, w, h); array-like [4, ...]."""
    x1, y1, x2, y2 = corner[0], corner[1], corner[2], corner[3]
    return (x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1


def center2corner(center):
    """(cx, cy, w, h) -> (x1, y1, x2, y2); array-like [4, ...]."""
    x, y, w, h = center[0], center[1], center[2], center[3]
    return x - w * 0.5, y - h * 0.5, x + w * 0.5, y + h * 0.5


def cxy_wh_2_rect(pos, sz):
    """Center + size -> [x, y, w, h] rect (0-indexed top-left)."""
    return np.array([pos[0] - sz[0] / 2, pos[1] - sz[1] / 2, sz[0], sz[1]])
