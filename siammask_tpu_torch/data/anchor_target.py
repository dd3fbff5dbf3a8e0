"""Anchor training targets (host-side numpy, run in the input pipeline).

Counterpart of ``siammask_tpu/data/anchor_target.py``, which reproduces the
reference ``AnchorTargetLayer``: IoU of the ground-truth box with every tiled
anchor; positives > 0.6, capped at 16 (a random subset); negatives < 0.3,
filled up to a 64-anchor batch; cls in {-1 ignore, 0, 1}; deltas as
(dxy / anchor_wh, log wh ratio); delta_weight = 1/num_pos on positives.
``neg`` mode marks only a centre 7x7 region negative (negative pairs).

The random subsets come from an explicit ``np.random.RandomState``, so a
seed replays them, and the same seed gives the JAX package's subsets.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from siammask_tpu_torch.tracker.anchors import Anchors
from siammask_tpu_torch.utils.bbox import bbox_iou, corner2center


@dataclass
class AnchorTargetConfig:
    thr_high: float = 0.6
    thr_low: float = 0.3
    negative: int = 16
    rpn_batch: int = 64
    positive: int = 16


class AnchorTarget:
    def __init__(self, rng: np.random.RandomState,
                 cfg: AnchorTargetConfig | None = None):
        self.cfg = cfg or AnchorTargetConfig()
        self.rng = rng

    def _select(self, position, keep_num):
        num = position[0].shape[0]
        if num <= keep_num:
            return position, num
        slt = np.arange(num)
        self.rng.shuffle(slt)
        slt = slt[:keep_num]
        return tuple(p[slt] for p in position), keep_num

    def __call__(self, anchor: Anchors, target, size: int, neg: bool = False):
        """anchor: ``Anchors`` with ``all_anchors`` generated; target: corner
        box (x1, y1, x2, y2) in search-crop pixels.

        Returns cls (K, S, S) int64, delta (4, K, S, S) float32 and
        delta_weight (K, S, S) float32."""
        anchor_num = anchor.anchors.shape[0]
        cls = np.full((anchor_num, size, size), -1, dtype=np.int64)
        delta = np.zeros((4, anchor_num, size, size), dtype=np.float32)
        delta_weight = np.zeros((anchor_num, size, size), dtype=np.float32)

        if neg:
            l = size // 2 - 3
            r = size // 2 + 3 + 1
            cls[:, l:r, l:r] = 0
            sel, _ = self._select(np.where(cls == 0), self.cfg.negative)
            cls[:] = -1
            cls[sel] = 0
            return cls, delta, delta_weight

        tcx, tcy, tw, th = corner2center(target)
        anchor_box, anchor_center = anchor.all_anchors
        x1, y1, x2, y2 = anchor_box
        cx, cy, w, h = anchor_center

        delta[0] = (tcx - cx) / w
        delta[1] = (tcy - cy) / h
        delta[2] = np.log(tw / w)
        delta[3] = np.log(th / h)

        overlap = bbox_iou([x1, y1, x2, y2], np.asarray(target, dtype=np.float64))
        pos = np.where(overlap > self.cfg.thr_high)
        neg_sel = np.where(overlap < self.cfg.thr_low)

        pos, pos_num = self._select(pos, self.cfg.positive)
        neg_sel, _ = self._select(neg_sel, self.cfg.rpn_batch - pos_num)

        cls[pos] = 1
        delta_weight[pos] = 1.0 / (pos_num + 1e-6)
        cls[neg_sel] = 0
        return cls, delta, delta_weight
