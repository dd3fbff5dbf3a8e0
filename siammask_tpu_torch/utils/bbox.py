"""Box geometry helpers (host-side numpy), with the reference's formulas.

Counterpart of the parts of ``siammask_tpu/utils/bbox.py`` that the tracker,
the VOT driver and the anchor-target code use: the ``Corner``/``Center``
tuples, the conversions between them, ``cxy_wh_2_rect``, ``rect_2_cxy_wh``,
``get_axis_aligned_bbox``, the vectorised ``bbox_iou`` and the training
augmentation's ``aug_apply``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Corner(NamedTuple):
    x1: object
    y1: object
    x2: object
    y2: object


class Center(NamedTuple):
    x: object
    y: object
    w: object
    h: object


def corner2center(corner):
    """(x1, y1, x2, y2) -> (cx, cy, w, h); a ``Corner`` gives a ``Center``,
    an array-like [4, ...] a tuple."""
    x1, y1, x2, y2 = corner[0], corner[1], corner[2], corner[3]
    out = (x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1
    return Center(*out) if isinstance(corner, Corner) else out


def center2corner(center):
    """(cx, cy, w, h) -> (x1, y1, x2, y2); a ``Center`` gives a ``Corner``,
    an array-like [4, ...] a tuple."""
    x, y, w, h = center[0], center[1], center[2], center[3]
    out = x - w * 0.5, y - h * 0.5, x + w * 0.5, y + h * 0.5
    return Corner(*out) if isinstance(center, Center) else out


def cxy_wh_2_rect(pos, sz):
    """Center + size -> [x, y, w, h] rect (0-indexed top-left)."""
    return np.array([pos[0] - sz[0] / 2, pos[1] - sz[1] / 2, sz[0], sz[1]])


def rect_2_cxy_wh(rect):
    """[x, y, w, h] rect -> (center, size) arrays."""
    return (np.array([rect[0] + rect[2] / 2, rect[1] + rect[3] / 2]),
            np.array([rect[2], rect[3]]))


def get_axis_aligned_bbox(region):
    """VOT region -> axis-aligned (cx, cy, w, h). An 8-point polygon keeps its
    area: the axis box is scaled to the rotated box's area, with the
    reference's +1 on each side; a 4-number rect is [x, y, w, h]."""
    region = np.asarray(region)
    if region.size == 8:
        cx = np.mean(region[0::2])
        cy = np.mean(region[1::2])
        x1, x2 = min(region[0::2]), max(region[0::2])
        y1, y2 = min(region[1::2]), max(region[1::2])
        a1 = np.linalg.norm(region[0:2] - region[2:4]) * np.linalg.norm(region[2:4] - region[4:6])
        a2 = (x2 - x1) * (y2 - y1)
        s = np.sqrt(a1 / a2)
        w = s * (x2 - x1) + 1
        h = s * (y2 - y1) + 1
    else:
        x, y, w, h = region[0], region[1], region[2], region[3]
        cx = x + w / 2
        cy = y + h / 2
    return cx, cy, w, h


def bbox_iou(rect1, rect2):
    """Vectorised IoU of corner boxes given as [4, ...] (or broadcastable)."""
    x1, y1, x2, y2 = rect1[0], rect1[1], rect1[2], rect1[3]
    tx1, ty1, tx2, ty2 = rect2[0], rect2[1], rect2[2], rect2[3]
    ww = np.maximum(0, np.minimum(tx2, x2) - np.maximum(tx1, x1))
    hh = np.maximum(0, np.minimum(ty2, y2) - np.maximum(ty1, y1))
    area = (x2 - x1) * (y2 - y1)
    target_a = (tx2 - tx1) * (ty2 - ty1)
    inter = ww * hh
    return inter / (area + target_a - inter)


def aug_apply(bbox, param, shape, inv=False, rd=False):
    """Shift and scale a corner box within the image bounds (the reference's
    ``aug_apply``), or undo a recorded shift/scale with ``inv``.

    Forward: the scale is clamped so the box fits the image, the shift so the
    box stays inside, the corners optionally rounded; returns (new_bbox,
    real_param) with the scale and shift actually applied."""
    if not inv:
        center = corner2center(bbox)
        original_center = center

        real_param = {}
        if 'scale' in param:
            scale_x, scale_y = param['scale']
            imh, imw = shape[:2]
            h, w = center.h, center.w
            scale_x = min(scale_x, float(imw) / w)
            scale_y = min(scale_y, float(imh) / h)
            center = Center(center.x, center.y, center.w * scale_x, center.h * scale_y)

        bbox = center2corner(center)

        if 'shift' in param:
            tx, ty = param['shift']
            x1, y1, x2, y2 = bbox
            imh, imw = shape[:2]
            tx = max(-x1, min(imw - 1 - x2, tx))
            ty = max(-y1, min(imh - 1 - y2, ty))
            bbox = Corner(x1 + tx, y1 + ty, x2 + tx, y2 + ty)

        if rd:
            bbox = Corner(*map(round, bbox))

        current_center = corner2center(bbox)
        real_param['scale'] = (current_center.w / original_center.w,
                               current_center.h / original_center.h)
        real_param['shift'] = (current_center.x - original_center.x,
                               current_center.y - original_center.y)
        return bbox, real_param

    scale_x, scale_y = param.get('scale', (1.0, 1.0))
    tx, ty = param.get('shift', (0, 0))
    center = corner2center(bbox)
    center = Center(center.x - tx, center.y - ty, center.w / scale_x, center.h / scale_y)
    return center2corner(center)
