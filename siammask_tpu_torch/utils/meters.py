"""Running metric meters (reference `utils/average_meter_helper.py`).

Counterpart of ``siammask_tpu/utils/meters.py`` (numpy only).
"""
from __future__ import annotations

import numpy as np


class Meter:
    def __init__(self, val=0, avg=0, sum_=0):
        self.val = val
        self.avg = avg
        self.sum = sum_

    def __repr__(self):
        return f"{self.val:.6f} ({self.avg:.6f})"

    def __format__(self, fmt):
        return f"{self.val:{fmt}} ({self.avg:{fmt}})"


class AverageMeter:
    """Dict of running sums; attribute access returns a Meter snapshot."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = {}
        self.sum = {}
        self.count = {}

    def update(self, batch=1, **kwargs):
        for k, v in kwargs.items():
            if k not in self.sum:
                self.sum[k] = 0
                self.count[k] = 0
            self.val[k] = v
            self.sum[k] += v * batch
            self.count[k] += batch

    def __getattr__(self, attr):
        if attr in ("val", "sum", "count"):
            raise AttributeError(attr)
        if attr not in self.__dict__["sum"]:
            raise AttributeError(attr)
        return Meter(self.val[attr], self.sum[attr] / self.count[attr],
                     self.sum[attr])

    def __repr__(self):
        return " ".join(f"{k} {Meter(self.val[k], self.sum[k] / self.count[k], self.sum[k])}"
                        for k in self.sum)


class IouMeter:
    """Per-frame mask IoU over a threshold list (average_meter_helper.py:71-113)."""

    def __init__(self, thrs, sz):
        self.thrs = thrs
        self.iou = np.zeros((sz, len(thrs)), dtype=np.float32)
        self.size = sz
        self.reset()

    def reset(self):
        self.iou.fill(0.0)
        self.n = 0

    def add(self, output, target):
        if self.n >= self.size:
            return
        target, output = np.asarray(target), np.asarray(output)
        for i, thr in enumerate(self.thrs):
            pred = output > thr
            mask_sum = (pred == 1).astype(np.uint8) + (target > 0).astype(np.uint8)
            intxn = np.sum(mask_sum == 2)
            union = np.sum(mask_sum > 0)
            if union > 0:
                self.iou[self.n, i] = intxn / union
            elif union == 0 and intxn == 0:
                self.iou[self.n, i] = 1
        self.n += 1

    def value(self, s):
        iou = self.iou[:self.n]
        if s == "mean":
            return iou.mean(axis=0)
        if s == "median":
            return np.median(iou, axis=0)
        if s.startswith("@"):
            thr = float(s[1:])
            return (iou > thr).mean(axis=0)
        raise ValueError(s)
